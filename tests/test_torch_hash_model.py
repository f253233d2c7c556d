"""The PyTorch port's hash-grid family against the JAX package: the
cropnerf preset at full MLP widths with a small grid of dense and hashed
levels, 3-level proposal grids and 32, 16 then 8 samples per ray
(torch_parity.reduced_cropnerf).  The field, the forward, the export and
the render, and one training step with camera-opt deltas (loss, its terms,
every gradient leaf, the rays' gradients) in the two arms of
tests/torch_parity.py; a step between proposal updates; the
cropnerf-tiny, semantic-nerf, cropnerf-big and cropnerf-huge presets end to
end on the port.

The grids are drawn uniform in ±0.5 (the ±1e-4 init would feed the MLPs
near-constant features).  Every gradient leaf, camera_opt and the rays'
gradients included, is held as tests/test_torch_train.py holds the leaves
outside the PE trunk: 1e-3 of its largest value in the f32 arm, atol 1e-3
and rtol 5e-2 in the bf16 arm.  No leaf of this model needs the wider
relu-kink bound: over ten pixel draws the float32 leaves moved by at most
9.3e-5 of their largest value (tools/torch_train_parity_draws.py
--preset cropnerf).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.models import field as jfield
from cropnerf_tpu.models import model as jmodel
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu_torch.convert import params_from_jax
from cropnerf_tpu_torch.models import field as tfield
from cropnerf_tpu_torch.models import model as tmodel
from cropnerf_tpu_torch.models import proposal as tproposal
from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
from cropnerf_tpu_torch.train import step as tstep
from cropnerf_tpu_torch.train.state import create_train_state
from test_torch_train import (N_IMG, PIXEL_SEED, RAYS, _banks, _close,
                              _jax_loss_fn, _jax_rays, _named)
from torch_parity import (ARM_TOL, Arm, arm, assert_close,  # noqa: F401
                          jax_bundle, ray_arrays, reduced_cropnerf,
                          torch_bundle)

N_RAYS = 64
UPDATE_STEP, FROZEN_STEP = 300, 5001      # proposal update / no update


def _cfgs(name="cropnerf", **changes):
    if name == "cropnerf":
        pair = reduced_cropnerf(JAX_PRESETS), reduced_cropnerf(TORCH_PRESETS)
    else:
        pair = JAX_PRESETS[name], TORCH_PRESETS[name]
    return tuple(dataclasses.replace(c, **changes) for c in pair)


@functools.lru_cache(maxsize=None)
def _numpy_tree(name: str):
    cfg = _cfgs(name)[0].model
    params = jax.jit(lambda k: jmodel.model_init(k, cfg, N_IMG))(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(11)
    for sub in tree.values():
        if isinstance(sub, dict) and "grid" in sub:
            sub["grid"] = rng.uniform(-0.5, 0.5, sub["grid"].shape).astype(
                np.float32)
    tree["camera_opt"] = (rng.standard_normal(tree["camera_opt"].shape)
                          * 0.05).astype(np.float32)
    return tree


def _params(name="cropnerf"):
    """(JAX params, the port's params_from_jax copy) of one seeded tree."""
    tree = _numpy_tree(name)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


@pytest.fixture
def f32(monkeypatch):
    """The float32 arm alone, for checks that one arm covers."""
    monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    jax.clear_caches()
    yield Arm("f32", torch.float32, ARM_TOL["f32"])
    jax.clear_caches()


def test_params_from_jax_keeps_the_hash_tree():
    _, tp = _params()
    ref = _named(_numpy_tree("cropnerf"))
    state = {k: v.numpy() for k, v in tp.state_dict().items()}
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k], v, k)
    assert state["field.grid"].ndim == 2                  # packed layout
    fresh = tmodel.model_init(_cfgs()[1].model, N_IMG,
                              torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in state.items()}
    assert fresh.field.grid.abs().max() <= 1e-4


def test_field_and_proposal_init_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _cfgs()[1].model
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfield.field_init(m.field, 2, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproposal.proposal_init(m.proposal_fields[0], gen)
    assert tfield.field_init(m.field, 2, gen, "cpu").grid.device.type == "cpu"


def test_field_matches_jax(arm):
    jcfg, tcfg = (c.model.field for c in _cfgs())
    params, tp = _params()
    rng = np.random.default_rng(12)
    pos = (rng.standard_normal((N_RAYS, 8, 3)) * 0.9).astype(np.float32)
    d = rng.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = (np.arange(N_RAYS) % N_IMG).astype(np.int32)

    def jax_fn(p):
        dens = jfield.field_density(p, jnp.asarray(pos), jcfg)
        return dens, [jfield.field_all(p, jnp.asarray(pos), jnp.asarray(d),
                                       jnp.asarray(cam), jcfg, train)
                      for train in (False, True)]

    (ref_density, ref_geo), ref_all = jax.jit(jax_fn)(params["field"])
    tpos, td = torch.from_numpy(pos), torch.from_numpy(d)
    density, geo = tfield.field_density(tp.field, tpos, tcfg,
                                        compute_dtype=arm.dtype)
    assert_close(torch.log(density), np.log(np.asarray(ref_density)),
                 arm.tol, "log density")
    assert_close(geo, ref_geo, arm.tol, "geo")
    for train, ref in zip((False, True), ref_all):
        got = tfield.field_all(tp.field, tpos, td,
                               torch.from_numpy(cam).long(), tcfg, train,
                               arm.dtype)
        assert_close(torch.log(got[0]), np.log(np.asarray(ref[0])), arm.tol,
                     f"log density, train={train}")
        for name, g, r in zip(("rgb", "semantics"), got[1:], ref[1:]):
            assert_close(g, r, arm.tol, f"{name}, train={train}")


def test_forward_matches_jax(arm):
    """Eval mode.  test_train_step_matches_jax holds train mode (the
    camera-opt deltas applied, the rays' appearance rows, an autograd
    graph) through the loss, its terms and its gradients."""
    jcfg, tcfg = (c.model for c in _cfgs())
    params, tp = _params()
    rays = ray_arrays(N_RAYS)
    ref = jax.jit(lambda p, rb: jmodel.forward(p, rb, jcfg, anneal=0.7))(
        params, jax_bundle(rays))
    got = tmodel.forward(tp, torch_bundle(rays), tcfg, anneal=0.7,
                         compute_dtype=arm.dtype)
    assert not got["rgb"].requires_grad
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap",
              "prop_depth_0", "prop_depth_1"):
        assert_close(got[k], ref[k], arm.tol, k)
    for i in range(3):
        assert_close(got["weights_list"][i], ref["weights_list"][i], arm.tol,
                     f"weights {i}")
        assert_close(got["sdist_list"][i], ref["sdist_list"][i], arm.tol,
                     f"sdist {i}")
    same_depth = np.isclose(got["depth"].detach().numpy(),
                            np.asarray(ref["depth"]), atol=arm.tol,
                            rtol=arm.tol)
    assert same_depth.mean() >= (1.0 if arm.name == "f32" else 0.9)


def test_export_and_render_match_jax(f32):
    """forward_export against JAX, and the chunked render, in the float32
    arm."""
    from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
    from test_torch_render_export import H as RH, W as RW, _camera_arrays
    jcfg, tcfg = _cfgs()
    params, tp = _params()
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    rays = ray_arrays(N_RAYS, seed=1, near=0.0, far=2.0)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, rb: jmodel.forward_export(
        p, rb, jcfg.model, 8, jnp.asarray(aabb), key=key,
        render_rgb_samples=True))(params, jax_bundle(rays))
    noise = np.array(jax.random.uniform(key, (N_RAYS, 9)))
    got = tmodel.forward_export(tp, torch_bundle(rays), tcfg.model, 8,
                                torch.from_numpy(aabb), True,
                                noise=torch.from_numpy(noise),
                                compute_dtype=f32.dtype)
    assert_close(got["point_location"], ref["point_location"], 1e-5, "pos")
    for k in ("semantics", "rgb"):
        assert_close(got[k], ref[k], f32.tol, k)
    assert_close(torch.log(got["density"]), np.log(np.asarray(ref["density"])),
                 f32.tol, "log density")

    # the render is forward(train=False), held against JAX above, over
    # padded chunks: two 48-ray chunks give what one 64-ray chunk gives
    cams = TorchCameras(**{k: torch.from_numpy(v)
                           for k, v in _camera_arrays().items()})
    two, one = (tstep.make_render_fn(dataclasses.replace(
        tcfg, eval_num_rays_per_chunk=chunk), compute_dtype=f32.dtype)(
            tp, cams, 0, RH, RW) for chunk in (48, RH * RW))
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap",
              "depth"):
        assert two[k].shape[:2] == (RH, RW) and torch.isfinite(two[k]).all()
        assert_close(two[k], one[k].numpy(), 1e-6, k)


def test_train_step_matches_jax(arm, monkeypatch):
    """One step at a proposal-update step.  Both sides run the proposal
    nets unconditionally (proposal_no_grad_schedule False): on an update
    step that is the branch the schedule takes, and it spares JAX tracing
    the lax.cond's other branch."""
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, proposal_no_grad_schedule=False))
        for c in _cfgs(train_num_rays_per_batch=RAYS))
    assert bool(tstep._prop_update_bool(UPDATE_STEP, tcfg))
    params, tp = _params()
    jb, tb = _banks()
    idx = np.random.default_rng(PIXEL_SEED).integers(0, jb.num_pixels, (RAYS,))
    jidx = jnp.asarray(idx, jnp.int32)
    (loss, aux), (grads, g_o, g_d) = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg, jb, jidx, UPDATE_STEP), argnums=(0, 1, 2),
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
    t_loss, t_aux = tstep.train_loss(tp, tb, torch.from_numpy(idx),
                                     UPDATE_STEP, tcfg,
                                     compute_dtype=arm.dtype)
    t_loss.backward()
    tol = 1e-4 if arm.name == "f32" else 5e-2
    atol = tol if arm.name == "f32" else 1e-3
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=tol, atol=atol)
    for k, v in aux.items():
        np.testing.assert_allclose(t_aux[k].item(), float(v), rtol=tol,
                                   atol=atol, err_msg=k)
    got = {k: p.grad.numpy() for k, p in tp.named_parameters()}
    ref = _named(grads)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.abs(r).sum() > 0, k
        _close(got[k], r, arm, k)
    _close(rays["rb"].origins.grad.numpy(), np.asarray(g_o), arm,
           "ray origins")
    _close(rays["rb"].directions.grad.numpy(), np.asarray(g_d), arm,
           "ray directions")


def test_step_between_proposal_updates_leaves_proposals_alone():
    """Off the update schedule the proposal nets run without a graph (the
    JAX lax.cond with stop_gradient): no proposal leaf gets a gradient,
    every other leaf does."""
    _, tcfg = _cfgs(train_num_rays_per_batch=RAYS)
    assert tcfg.model.proposal_no_grad_schedule
    assert not bool(tstep._prop_update_bool(FROZEN_STEP, tcfg))
    _, tp = _params()
    _, tb = _banks()
    idx = np.random.default_rng(PIXEL_SEED).integers(0, tb.num_pixels, (RAYS,))
    loss, aux = tstep.train_loss(tp, tb, torch.from_numpy(idx), FROZEN_STEP,
                                 tcfg, compute_dtype=torch.float32)
    loss.backward()
    for k, p in tp.named_parameters():
        frozen = k.startswith("proposal_")
        assert (p.grad is None) == frozen, k
        assert frozen or p.grad.abs().sum() > 0, k
    assert torch.isfinite(loss) and aux["interlevel_loss"] > 0


def _small(cfg):
    """``cfg`` at its widths with 32, 16 then 8 samples per ray and hash
    tables of at most 2^12 rows."""
    def grid(g):
        return dataclasses.replace(
            g, log2_hashmap_size=min(g.log2_hashmap_size, 12))
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, grid=grid(m.field.grid)),
        proposal_fields=tuple(dataclasses.replace(p, grid=grid(p.grid))
                              for p in m.proposal_fields),
        num_nerf_samples_per_ray=8,
        num_proposal_samples_per_ray=(32, 16)[:m.num_proposal_iterations]))


@pytest.mark.parametrize("name", ["cropnerf-tiny", "semantic-nerf",
                                  "cropnerf-big", "cropnerf-huge"])
def test_preset_runs_end_to_end(name):
    """model_init, two training steps, forward, forward_export and the
    render of the preset, on the port alone: cropnerf-tiny as it is, the
    others with fewer samples and tables of at most 2^12 rows (big and huge
    train with RAdam)."""
    changes = dict(train_num_rays_per_batch=64, eval_num_rays_per_batch=16,
                   eval_num_rays_per_chunk=16)
    _, cfg = _cfgs(name, **changes)
    if name != "cropnerf-tiny":
        cfg = _small(cfg)
    m = cfg.model
    _, tb = _banks()
    state = create_train_state(cfg, N_IMG, torch.Generator().manual_seed(0),
                               device="cpu")
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    state, metrics = tstep.make_train_step(cfg, num_inner=2)(
        state, tb, torch.Generator().manual_seed(1))
    assert state.step == 2
    assert all(torch.isfinite(v) for v in metrics.values())
    moved = {k: not torch.equal(v, before[k])
             for k, v in state.params.state_dict().items()}
    if cfg.optimizer == "adam":
        assert all(moved.values()), moved
    else:
        # RAdam's first steps are lr·m̂ (no rectification before step 5):
        # the proposal weights' tiny gradients move no float32 weight
        for top in {k.split(".")[0] for k in moved}:
            assert any(m for k, m in moved.items() if k.startswith(top)), top
    rb = torch_bundle(ray_arrays(16))
    out = tmodel.forward(state.params, rb, m)
    assert out["rgb"].shape == (16, 3) and torch.isfinite(out["rgb"]).all()
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3])
    exp = tmodel.forward_export(state.params, rb, m, 4, aabb, True)
    assert exp["density"].shape == (16, 4) and exp["rgb"].shape == (16, 4, 3)
    from test_torch_render_export import _camera_arrays
    from cropnerf_tpu_torch.core.cameras import Cameras
    cams = Cameras(**{k: torch.from_numpy(v)
                      for k, v in _camera_arrays().items()})
    img = tstep.make_render_fn(cfg)(state.params, cams, 0, 8, 8)
    assert img["rgb"].shape == (8, 8, 3) and torch.isfinite(img["rgb"]).all()
