"""The PyTorch port's training step against the JAX package: one
cropnerf-mxu step at full widths with few samples (reduced_mxu), 32 rays
from a small synthetic pixel bank, the same pixel indices and no jitter on
both sides; then its pieces (train-mode forward with camera-opt deltas,
losses, the camera-opt exponential map, the schedules, the optimizer) and
the rule that serving records no autograd graph.

Tolerances: the f32 arm holds the loss to 1e-4 and gradient leaves to
1e-3 of their largest value; the bf16 arm holds both to atol 1e-3, rtol
5e-2, the JAX package's own flagship tolerance between two bf16 programs.
Gradients that pass through the trunk's relu units take a wider bound
(KINK_TOL, in relative L2 norm, with the measurement behind it).  The camera-opt leaf is a sum
of per-ray pose gradients that cancel (the JAX package measures a ~3.5e-4
reassociation floor for it even in float32): the rays' gradients are held
directly, and the camera-opt leaf to their tolerance times the sum of
their magnitudes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cropnerf_tpu.core.cameras import Cameras as JaxCameras
from cropnerf_tpu.core.cameras import generate_rays as jax_generate_rays
from cropnerf_tpu.core.cameras import near_far_collider as jax_collider
from cropnerf_tpu.core.rays import RayBundle as JaxRayBundle
from cropnerf_tpu.data import databank as jbank
from cropnerf_tpu.models import camera_opt as jcam
from cropnerf_tpu.models import model as jmodel
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.ops import activations as jact
from cropnerf_tpu.ops import losses as jlosses
from cropnerf_tpu.ops import metrics as jmetrics
from cropnerf_tpu.train import optim as joptim
from cropnerf_tpu.train import step as jstep
from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
from cropnerf_tpu_torch.data import databank as tbank
from cropnerf_tpu_torch.models import camera_opt as tcam
from cropnerf_tpu_torch.models import model as tmodel
from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
from cropnerf_tpu_torch.ops import activations as tact
from cropnerf_tpu_torch.ops import losses as tlosses
from cropnerf_tpu_torch.ops import metrics as tmetrics
from cropnerf_tpu_torch.train import optim as toptim
from cropnerf_tpu_torch.train import step as tstep
from cropnerf_tpu_torch.train.state import create_train_state
from torch_parity import (arm, assert_close, jax_and_torch_params,  # noqa: F401
                          jax_bundle, ray_arrays, reduced_mxu, torch_bundle)

N_IMG, H, W, RAYS = 4, 12, 16, 32
STEP = 300


def _bank_arrays(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (N_IMG, H, W, 3), dtype=np.uint8)
    masks = (rng.rand(N_IMG, H, W) > 0.7).astype(np.uint8)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_IMG, 1, 1))
    c2w[:, :, 3] = (rng.randn(N_IMG, 3) * 0.5).astype(np.float32)
    cams = dict(c2w=c2w, fx=np.full((N_IMG,), 14.0, np.float32),
                fy=np.full((N_IMG,), 14.0, np.float32),
                cx=np.full((N_IMG,), W / 2, np.float32),
                cy=np.full((N_IMG,), H / 2, np.float32),
                width=np.full((N_IMG,), W, np.int32),
                height=np.full((N_IMG,), H, np.int32))
    return images, masks, cams


def _banks():
    images, masks, cams = _bank_arrays()
    jb = jbank.build_pixel_bank(
        images, masks, JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()}))
    tb = tbank.build_pixel_bank(
        images, masks, TorchCameras(**{k: torch.from_numpy(v)
                                       for k, v in cams.items()}),
        device="cpu")
    return jb, tb


def _cfgs(**changes):
    base = dict(train_num_rays_per_batch=RAYS)
    base.update(changes)
    return (dataclasses.replace(reduced_mxu(JAX_PRESETS), **base),
            dataclasses.replace(reduced_mxu(TORCH_PRESETS), **base))


def _leaf_name(path) -> str:
    key = jax.tree_util.keystr(path)
    return ".".join(key.replace("['", ".").replace("']", "").replace("[", ".")
                    .replace("]", "").split(".")[1:])


def _named(tree):
    return {_leaf_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_rays(bank, idx):
    cam, px, py = jbank.decode_pixel_index(idx, bank.height, bank.width)
    return jax_generate_rays(bank.cameras, cam, px, py)


def _jax_loss_fn(cfg, bank, idx, step):
    """The closure loss_fn of the JAX make_train_step, from the public
    functions it composes (key None: no jitter), with the generated ray
    origins and directions as arguments so that their gradients show."""
    m = cfg.model
    R = idx.shape[0]
    step = jnp.asarray(step, jnp.int32)

    def loss_fn(params, origins, dirs):
        cam, _, _ = jbank.decode_pixel_index(idx, bank.height, bank.width)
        rgb_gt = bank.rgb[idx].astype(jnp.float32) / 255.0
        mask_gt = bank.mask[idx].astype(jnp.float32)
        rb = JaxRayBundle(origins=origins, directions=dirs,
                          nears=jnp.zeros((R,)), fars=jnp.ones((R,)),
                          camera_idx=cam)
        rb = jax_collider(rb, m.near_plane, m.far_plane)
        upd = jstep._prop_update_bool(step, cfg)
        outputs = jmodel.forward(
            params, rb, m, key=None, train=True,
            anneal=jmodel.anneal_factor(step, m),
            prop_update=upd if m.proposal_no_grad_schedule else None)
        loss, aux = jstep.compute_losses(params, outputs, rgb_gt, mask_gt,
                                         cfg, upd.astype(jnp.float32))
        aux["psnr"] = jmetrics.psnr(outputs["rgb"], rgb_gt)
        return loss, aux

    return loss_fn


# Gradients below the trunk's relu units (the trunk's leaves, and the rays'
# gradients, which come through dx) are held in relative L2 norm to a wider
# bound.  XLA and PyTorch sum in other orders, and a unit whose
# pre-activation lies within rounding of zero may take the other side, which
# moves such a leaf by a sample's share.  tools/torch_train_parity_draws.py
# measures it over ten draws of 32 pixels in float32: trunk leaves up to
# 2.79e-2 of their largest value (8 draws above 1e-3), the other leaves up
# to 2.2e-5 on 9 draws; on 3 draws the port moves as far from itself when
# its products are summed in float64.  On this draw: up to 1.3e-2 (f32) and
# 7.1e-2 (bf16, the rays' directions) in L2.
KINK_TOL = {"f32": 3e-2, "bf16": 1e-1}
PIXEL_SEED = 3


def _close(got, ref, arm, what, kinked=False, kink_tol=KINK_TOL):
    if kinked:
        err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err <= kink_tol[arm.name], (what, err)
    elif arm.name == "f32":
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
        assert err <= 1e-3, (what, err)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=5e-2,
                                   err_msg=what)


def _kinked(leaf: str) -> bool:
    return leaf.startswith(("field.mlp_base", "field.mlp_top"))


@pytest.mark.parametrize("no_grad_schedule", [False, True],
                         ids=["preset", "prop-schedule"])
def test_train_step_loss_and_gradients_match_jax(arm, no_grad_schedule,
                                                 monkeypatch):
    jcfg, tcfg = _cfgs()
    if no_grad_schedule:      # the lax.cond path, on a non-update step
        jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
            c.model, proposal_no_grad_schedule=True)) for c in (jcfg, tcfg))
    step = 4001 if no_grad_schedule else STEP
    assert bool(tstep._prop_update_bool(step, tcfg)) != no_grad_schedule
    check_train_step(jcfg, tcfg, step, arm, monkeypatch)


def check_train_step(jcfg, tcfg, step, arm, monkeypatch, kinked=None,
                     kink_tol=None):
    """One training step of ``tcfg`` on the port against ``jcfg`` on JAX,
    from the same parameters and pixels: the loss and its terms, every
    gradient leaf (the trunk's, or those ``kinked`` names, under the
    relu-kink bound: KINK_TOL, or ``kink_tol``), the rays' gradients and
    the camera-opt leaf."""
    kinked = kinked or _kinked
    kink_tol = kink_tol or KINK_TOL
    frozen = (tcfg.model.proposal_no_grad_schedule
              and not bool(tstep._prop_update_bool(step, tcfg)))
    params, tp = jax_and_torch_params(jcfg.model, num_images=N_IMG)
    jb, tb = _banks()
    idx = np.random.default_rng(PIXEL_SEED).integers(0, jb.num_pixels, (RAYS,))
    jidx = jnp.asarray(idx, jnp.int32)
    (loss, aux), (grads, g_o, g_d) = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, jb, jidx, step), argnums=(0, 1, 2),
        has_aux=True))(params, *_jax_rays(jb, jidx))

    rays = {}
    bank_rays = tstep._bank_rays

    def spy(*args):               # the port's rays, to read their gradients
        out = bank_rays(*args)
        rays["rb"] = out[2]
        out[2].origins.requires_grad_(True)
        out[2].directions.requires_grad_(True)
        return out

    monkeypatch.setattr(tstep, "_bank_rays", spy)
    t_loss, t_aux = tstep.train_loss(tp, tb, torch.from_numpy(idx), step,
                                     tcfg, compute_dtype=arm.dtype)
    t_loss.backward()
    tol = 1e-4 if arm.name == "f32" else 5e-2
    atol = tol if arm.name == "f32" else 1e-3
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=tol, atol=atol)
    for k, v in aux.items():
        np.testing.assert_allclose(t_aux[k].item(), float(v), rtol=tol,
                                   atol=atol, err_msg=k)
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in tp.named_parameters()}
    ref = _named(grads)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if k != "camera_opt":
            _close(got[k].numpy(), r, arm, k, kinked(k), kink_tol)
    if frozen:
        assert all(got[k].abs().sum() == 0 for k in got
                   if k.startswith("proposal_"))
    # camera_opt sums each camera's rays' pose gradients, which cancel: it
    # is held to the rays' tolerance times the sum of their magnitudes
    g_o, g_d = np.asarray(g_o), np.asarray(g_d)
    _close(rays["rb"].origins.grad.numpy(), g_o, arm, "ray origins", True,
           kink_tol)
    _close(rays["rb"].directions.grad.numpy(), g_d, arm, "ray directions",
           True, kink_tol)
    cam = idx // (H * W)
    scale = np.zeros((N_IMG, 6), np.float32)
    np.add.at(scale[:, :3], cam, np.abs(g_o))
    np.add.at(scale[:, 3:], cam, np.linalg.norm(g_d, axis=1)[:, None])
    cam_tol = kink_tol[arm.name]
    diff = np.abs(got["camera_opt"].numpy() - ref["camera_opt"])
    assert np.all(diff <= cam_tol * scale + 1e-7), (diff / scale).max()


def test_optimizer_updates_match_optax():
    """Three updates from identical gradients: the three groups' eps and
    schedules (short decays, so each schedule moves within three steps)."""
    jcfg, tcfg = _cfgs(lr_decay_max_steps=4, prop_lr_decay_max_steps=2,
                       camera_opt_decay_steps=1)
    params, tp = jax_and_torch_params(jcfg.model, num_images=N_IMG)
    tx = joptim.make_optimizer(jcfg)
    opt_state = tx.init(params)
    topt = toptim.make_optimizer(tp, tcfg)
    assert {g["name"] for g in topt.param_groups} == set(toptim.GROUPS)
    rng = np.random.default_rng(2)
    tparams = dict(tp.named_parameters())
    for step in range(3):
        g_np = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape)
                       * 10.0 ** rng.uniform(-4, 0)).astype(np.float32),
            params)
        updates, opt_state = tx.update(g_np, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, v in _named(g_np).items():
            tparams[k].grad = torch.from_numpy(v.copy())
        toptim.apply_updates(topt, tcfg, step)
    for k, v in _named(params).items():
        np.testing.assert_allclose(tparams[k].detach().numpy(), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_schedules_match_jax():
    cfg = JAX_PRESETS["cropnerf-mxu"]
    for init, final, steps in ((cfg.learning_rate, cfg.lr_final,
                                cfg.lr_decay_max_steps),
                               (cfg.camera_opt_lr, cfg.camera_opt_lr_final,
                                cfg.camera_opt_decay_steps),
                               (1e-2, None, 100)):
        js = joptim.exp_decay_schedule(init, final, steps)
        ts = toptim.exp_decay_schedule(init, final, steps)
        for step in (0, 1, 7, steps // 2, steps, 2 * steps):
            ref = js(jnp.asarray(step, jnp.int32)) if callable(js) else js
            np.testing.assert_allclose(ts(step), float(ref), rtol=1e-7)
    for key in ("camera_opt", "proposal_0", "proposal_1", "field"):
        assert toptim.optimizer_group_of(key) == joptim.optimizer_group_of(key)


OPTIMIZER_FIELDS = (
    "optimizer", "learning_rate", "adam_eps", "lr_final",
    "prop_learning_rate", "prop_lr_final", "camera_opt_optimizer",
    "camera_opt_lr", "camera_opt_eps", "camera_opt_weight_decay",
    "camera_opt_lr_final")


@pytest.mark.parametrize("preset", ["cropnerf-big", "cropnerf-huge",
                                    "cropnerf-mxu-huge"])
def test_radam_updates_match_optax(preset):
    """Three updates from identical gradients under a RAdam preset's group
    settings (kinds, eps, coupled weight decay, schedules with short
    decays), on a cropnerf-tiny parameter set: RAdam for the fields and
    proposal nets beside Adam for camera_opt (big), RAdam for every group
    with weight decay on camera_opt (huge), and Adam for the fields and
    proposal nets beside RAdam for camera_opt (mxu-huge)."""
    src = TORCH_PRESETS[preset]
    settings = {k: getattr(src, k) for k in OPTIMIZER_FIELDS}
    tcfg = dataclasses.replace(TORCH_PRESETS["cropnerf-tiny"], **settings,
                               lr_decay_max_steps=4,
                               prop_lr_decay_max_steps=2,
                               camera_opt_decay_steps=1)
    jcfg = dataclasses.replace(JAX_PRESETS["cropnerf-tiny"], **settings,
                               lr_decay_max_steps=4,
                               prop_lr_decay_max_steps=2,
                               camera_opt_decay_steps=1)
    tp = tmodel.model_init(tcfg.model, N_IMG, torch.Generator().manual_seed(0),
                           device="cpu")
    tparams = dict(tp.named_parameters())

    def tree(arrays):       # {top-level key: {rest of the name: array}}
        out = {}            # (copies: the port updates its tensors in place)
        for name, a in arrays.items():
            top, _, rest = name.partition(".")
            if rest:
                out.setdefault(top, {})[rest] = jnp.array(a)
            else:
                out[top] = jnp.array(a)
        return out

    params = tree({k: p.detach().numpy() for k, p in tparams.items()})
    tx = joptim.make_optimizer(jcfg)
    opt_state = tx.init(params)
    topt = toptim.make_optimizer(tp, tcfg)
    names = {"adam": "Adam", "radam": "RAdam"}
    assert {type(o).__name__ for o in topt.optimizers} == {
        names[settings["optimizer"]], names[settings["camera_opt_optimizer"]]}
    update = jax.jit(tx.update)
    rng = np.random.default_rng(4)
    for step in range(3):
        g_np = {k: (rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-4, 0)
                    ).astype(np.float32) for k, p in tparams.items()}
        updates, opt_state = update(tree(g_np), opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, v in g_np.items():
            tparams[k].grad = torch.from_numpy(v.copy())
        toptim.apply_updates(topt, tcfg, step)
    for k, p in tparams.items():
        top, _, rest = k.partition(".")
        ref = params[top][rest] if rest else params[top]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_forward_train_with_camera_deltas_matches_jax(arm):
    jcfg, tcfg = _cfgs()
    params, tp = jax_and_torch_params(jcfg.model, num_images=4)
    deltas = (np.random.default_rng(3).standard_normal((4, 6)) * 0.05
              ).astype(np.float32)
    params["camera_opt"] = jnp.asarray(deltas)
    with torch.no_grad():
        tp.camera_opt.copy_(torch.from_numpy(deltas))
    rays = ray_arrays(RAYS, seed=4)
    ref = jax.jit(lambda p, rb: jmodel.forward(
        p, rb, jcfg.model, key=None, train=True, anneal=0.7))(
            params, jax_bundle(rays))
    got = tmodel.forward(tp, torch_bundle(rays), tcfg.model, train=True,
                         anneal=0.7, compute_dtype=arm.dtype)
    assert got["rgb"].requires_grad
    for k in ("rgb", "accumulation", "semantics", "prop_depth_0",
              "prop_depth_1"):
        assert_close(got[k], ref[k], arm.tol, k)
    for i in range(3):
        assert_close(got["weights_list"][i], ref["weights_list"][i], arm.tol,
                     f"weights {i}")
        assert_close(got["sdist_list"][i], ref["sdist_list"][i], arm.tol,
                     f"sdist {i}")


def _loss_inputs(rng, R=16, S=12, M=20):
    sdist = np.sort(rng.uniform(0, 1, (R, S + 1)), axis=-1).astype(np.float32)
    sdist[:, 0], sdist[:, -1] = 0.0, 1.0
    sprop = np.sort(rng.uniform(0, 1, (R, M + 1)), axis=-1).astype(np.float32)
    sprop[:, 0], sprop[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 0.2, (R, S)).astype(np.float32)
    wp = rng.uniform(0, 0.2, (R, M)).astype(np.float32)
    return sdist, sprop, w, wp


@pytest.mark.parametrize("name", ["mse", "mse_mask", "bce", "bce_mask",
                                  "interlevel", "distortion", "camera_zero",
                                  "camera"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(6)
    sdist, sprop, w, wp = _loss_inputs(rng)
    pred = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    logits = (rng.standard_normal(16) * 3).astype(np.float32)
    labels = (rng.uniform(size=16) > 0.5).astype(np.float32)
    mask = (rng.uniform(size=16) > 0.3).astype(np.float32)
    pose = (np.zeros((4, 6)) if name == "camera_zero"
            else rng.standard_normal((4, 6)) * 0.1).astype(np.float32)
    cases = {
        "mse": (lambda L, a: L.mse_loss(a[0], a[1]), [pred, tgt]),
        "mse_mask": (lambda L, a: L.mse_loss(a[0], a[1], a[2]),
                     [pred, tgt, mask]),
        "bce": (lambda L, a: L.bce_with_logits(a[0], a[1]), [logits, labels]),
        "bce_mask": (lambda L, a: L.bce_with_logits(a[0], a[1], a[2]),
                     [logits, labels, mask]),
        "interlevel": (lambda L, a: L.interlevel_loss([a[0], a[1]],
                                                      [a[2], a[3]]),
                       [wp, w, sprop, sdist]),
        "distortion": (lambda L, a: L.distortion_loss(a[0], a[1]),
                       [w, sdist]),
        "camera_zero": (lambda L, a: L.camera_opt_regularizer(a[0]), [pose]),
        "camera": (lambda L, a: L.camera_opt_regularizer(a[0], 0.3, 0.7),
                   [pose]),
    }
    fn, args = cases[name]
    ref, ref_g = jax.value_and_grad(lambda a0: fn(jlosses, [a0] + [
        jnp.asarray(a) for a in args[1:]]))(jnp.asarray(args[0]))
    t0 = torch.from_numpy(args[0]).requires_grad_(True)
    got = fn(tlosses, [t0] + [torch.from_numpy(a) for a in args[1:]])
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t0.grad.numpy(), np.asarray(ref_g), rtol=1e-4,
                               atol=1e-7)
    assert np.isfinite(t0.grad.numpy()).all()


def test_psnr_matches_jax():
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    for tgt in (rng.uniform(0, 1, (64, 3)).astype(np.float32), pred):
        np.testing.assert_allclose(
            tmetrics.psnr(torch.from_numpy(pred), torch.from_numpy(tgt)).item(),
            float(jmetrics.psnr(jnp.asarray(pred), jnp.asarray(tgt))),
            rtol=1e-6)


@pytest.mark.parametrize("scale", [0.0, 1e-12, 1e-6, np.pi / 2],
                         ids=["zero", "1e-12", "1e-6", "half-pi"])
def test_exp_so3_matches_jax(scale):
    rng = np.random.default_rng(7)
    axis = rng.standard_normal((5, 3))
    omega = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)
             * scale).astype(np.float32)
    probe = rng.standard_normal((5, 3, 3)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda o: jnp.sum(jcam.exp_so3(o) * probe))(jnp.asarray(omega))
    t = torch.from_numpy(omega).requires_grad_(True)
    R = tcam.exp_so3(t)
    (R * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(R.detach().numpy(),
                               np.asarray(jcam.exp_so3(jnp.asarray(omega))),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5)


def test_prop_update_schedule_and_anneal_match_jax():
    steps = np.arange(0, 12_001, dtype=np.int32)
    for cfg in (JAX_PRESETS["cropnerf-mxu"], JAX_PRESETS["cropnerf"]):
        ref = np.asarray(jstep._prop_update_bool(jnp.asarray(steps), cfg))
        got = tstep._prop_update_bool(torch.from_numpy(steps), cfg).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(
            tmodel.anneal_factor(torch.from_numpy(steps), cfg.model).numpy(),
            np.asarray(jmodel.anneal_factor(jnp.asarray(steps), cfg.model)),
            rtol=1e-6)


def test_decode_pixel_index_matches_jax():
    idx = np.random.default_rng(8).integers(0, 32 * 800 * 1200, (1000,))
    ref = jbank.decode_pixel_index(jnp.asarray(idx, jnp.int32), 800, 1200)
    got = tbank.decode_pixel_index(torch.from_numpy(idx), 800, 1200)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_trunc_exp_gradient_is_jax_g_times_y():
    x = np.float32([-20, -1, 0, 3, 20])
    g = np.float32([0.5, -2.0, 1.0, 0.25, 3.0])
    ref_y, vjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    y = tact.trunc_exp(t)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6)
    assert t.grad[0] != 0 and t.grad[-1] != 0      # not the clamp's zero


def test_serving_records_no_graph():
    _, tcfg = _cfgs()
    _, tp = jax_and_torch_params(reduced_mxu(JAX_PRESETS).model)
    assert all(p.requires_grad for p in tp.parameters())
    rb = torch_bundle(ray_arrays(8))
    out = tmodel.forward(tp, rb, tcfg.model)
    leaves = [v for v in out.values() if torch.is_tensor(v)]
    leaves += out["weights_list"] + out["sdist_list"]
    assert leaves and not any(v.requires_grad for v in leaves)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3])
    exp = tmodel.forward_export(tp, rb, tcfg.model, 4, aabb, True)
    acc = tmodel.forward_accumulation(tp, rb, tcfg.model)
    assert not any(v.requires_grad for v in [*exp.values(), acc])


def test_make_train_step_updates_in_place_and_eval_batch_runs():
    _, tcfg = _cfgs(eval_num_rays_per_batch=16)
    _, tb = _banks()
    state = create_train_state(tcfg, N_IMG, torch.Generator().manual_seed(0),
                               device="cpu")
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    step = tstep.make_train_step(tcfg, num_inner=2)
    state2, metrics = step(state, tb, torch.Generator().manual_seed(1))
    assert state2 is state and state.step == 2
    assert all(m.dim() == 0 and not m.requires_grad and torch.isfinite(m)
               for m in metrics.values())
    assert set(metrics) == {"loss", "rgb_loss", "semantics_loss",
                            "interlevel_loss", "distortion_loss",
                            "camera_opt_regularizer", "psnr"}
    assert all(not torch.equal(v, before[k])
               for k, v in state.params.state_dict().items())
    ev = tstep.make_eval_batch_fn(tcfg)(state.params, tb,
                                        torch.Generator().manual_seed(2))
    assert set(ev) == set(metrics) and all(torch.isfinite(v) for v in ev.values())
