"""The PyTorch port's BayesRays uncertainty against the JAX module
(cropnerf_tpu/uncertainty/bayesrays.py), on the CPU.

Models: the reduced cropnerf (hash grids drawn in ±0.5, as in
tests/test_torch_hash_model.py) and the reduced cropnerf-mxu
(``mlp_impl="pallas-fused"``: the port's plain K2/K3 paths, JAX's jnp
mirrors), both at full MLP widths with 32, 16 then 8 samples per ray.

Tolerances:
* geometry (corner indices, coefficients, normalisation) repeats the JAX
  arithmetic operation for operation: indices equal, floats to 1e-6;
* ``uncertainty_at`` on one grid: 1e-5 (log10 of the same sums);
* the Hessian grid: a sum of squared position gradients.  The PE trunk's
  position gradients cross relu units that sit within float32 rounding of
  zero, and the two frameworks' summation orders put some of them on the
  other side (up to 2.79e-2 on the trunk's leaves, measured by
  tools/torch_train_parity_draws.py), so
  every grid is held in relative L2 norm (1e-3 in the f32 arm, 2e-2 in the
  bf16 arm; measured at most 3.7e-4 and 5.8e-3) and by the overlap of its
  50 hottest cells (at least 90 %); the hash model, which has no such
  kinks, also cell by cell in the f32 arm, to 1e-4 of its largest cell
  (measured 3.7e-5);
* outputs of the filtered forward, render and per-ray uncertainty: the
  arm tolerances of tests/torch_parity.py.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.core.cameras import Cameras as JaxCameras
from cropnerf_tpu.models import model as jmodel
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.train.step import make_render_fn as jax_make_render_fn
from cropnerf_tpu.uncertainty import bayesrays as jbr
from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
from cropnerf_tpu_torch.models import model as tmodel
from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
from cropnerf_tpu_torch.train.step import make_render_fn
from cropnerf_tpu_torch.uncertainty import bayesrays as tbr
from test_torch_hash_model import _params as hash_params
from test_torch_render_export import H, W, _camera_arrays
from torch_parity import (arm, assert_close, jax_and_torch_params,  # noqa: F401
                          jax_bundle, ray_arrays, reduced_cropnerf,
                          reduced_mxu, torch_bundle)

LOD = 4
CELLS = (2 ** LOD + 1) ** 3
N_RAYS = 16
N_SAMPLES = 32                  # rays·batches the synthetic grid stands for
GRID_L2 = {"f32": 1e-3, "bf16": 2e-2}
PRESETS = ["cropnerf", "cropnerf-mxu"]


def _models(preset):
    """(JAX model config, port model config, JAX params, port params)."""
    if preset == "cropnerf":
        jp, tp = hash_params()
        return (reduced_cropnerf(JAX_PRESETS).model,
                reduced_cropnerf(TORCH_PRESETS).model, jp, tp)
    jm = reduced_mxu(JAX_PRESETS).model
    jp, tp = jax_and_torch_params(jm)
    return jm, reduced_mxu(TORCH_PRESETS).model, jp, tp


def _rays(seed):
    return ray_arrays(N_RAYS, seed=seed, near=0.05, far=10.0)


def _grid(seed=0):
    """A Hessian grid whose pointwise uncertainty spans the filter
    threshold: H/N log-uniform in [1e-5, 1e3]."""
    rng = np.random.default_rng(seed)
    return (N_SAMPLES * 10.0 ** rng.uniform(-5, 3, CELLS)).astype(np.float32)


def _points(seed=0, n=256):
    """World points over the contracted scene, a point at unit coordinate
    exactly 1 (x → +inf contracts to 2) and one on a lattice vertex."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    pts[0] = [1e8, 0.0, 0.0]                        # unit (1, 0.5, 0.5)
    pts[1] = [-0.5, 0.0, 0.5]                       # unit (3/8, 1/2, 5/8)
    return pts


def _hot_overlap(got, ref, k=50):
    return len(set(np.argsort(got)[-k:]) & set(np.argsort(ref)[-k:])) / k


# ---- geometry -------------------------------------------------------------

@pytest.mark.parametrize("lod", [2, LOD])
def test_grid_corner_indices_match_jax(lod):
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    pos[0] = [1.0, 0.5, 0.25]                       # unit coordinate 1.0
    pos[1] = [1.0, 1.0, 1.0]
    pos[2] = [0.25, 0.5, 0.75]                      # a lattice vertex
    sel = (rng.uniform(size=200) > 0.1).astype(np.float32)
    ref_i, ref_c = jbr.grid_corner_indices(jnp.asarray(pos), jnp.asarray(sel),
                                           lod)
    got_i, got_c = tbr.grid_corner_indices(torch.from_numpy(pos),
                                           torch.from_numpy(sel), lod)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert_close(got_c, ref_c, 1e-6, "coeffs")
    cells = (2 ** lod + 1) ** 3
    assert got_i.max() >= cells            # the far corner of x = 1.0
    assert float(got_c[got_i >= cells].abs().max()) == 0.0
    lattice = got_c[:, 2].argmax()
    assert float(got_c[lattice, 2]) == pytest.approx(1.0, abs=1e-6)


def test_grid_corner_indices_are_exact_at_lod_8():
    """The index is exact integer arithmetic: the JAX module's float32
    index rounds above 2^24 (x corner >= 255 at lod 8), the port's does
    not."""
    pos = torch.tensor([[1.0, 0.0, 0.0], [255.5 / 256, 1 / 256, 3 / 256]])
    inds, _ = tbr.grid_corner_indices(pos, torch.ones(2), 8)
    b = torch.floor(pos * 256).long()
    side = 257
    for corner in range(8):
        d = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
        want = ((b[:, 0] + d[0]) * side + b[:, 1] + d[1]) * side + b[:, 2] + d[2]
        assert torch.equal(inds[corner], want)
    assert int(inds[0, 1]) % 2 == 1 and int(inds[0, 1]) > 2 ** 24


def test_normalize_points_matches_jax():
    pts = _points()
    cfg_j, cfg_t = JAX_PRESETS["cropnerf"].model, TORCH_PRESETS["cropnerf"].model
    ref_p, ref_s = jbr.normalize_points(jnp.asarray(pts), cfg_j)
    got_p, got_s = tbr.normalize_points(torch.from_numpy(pts), cfg_t)
    assert_close(got_p, ref_p, 1e-6, "unit")
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert float(got_p[0, 0]) == 1.0 and float(got_s[0]) == 1.0


def test_uncertainty_at_matches_jax():
    pts, grid = _points(), _grid()
    cfg_j, cfg_t = JAX_PRESETS["cropnerf"].model, TORCH_PRESETS["cropnerf"].model
    ref = jbr.uncertainty_at(jnp.asarray(pts).reshape(16, 16, 3),
                             jnp.asarray(grid), cfg_j, LOD, N_SAMPLES)
    got = tbr.uncertainty_at(torch.from_numpy(pts).reshape(16, 16, 3), grid,
                             cfg_t, LOD, N_SAMPLES)
    assert got.shape == (16, 16)
    assert_close(got, ref, 1e-5, "uncertainty")
    assert 0.0 <= float(got.min()) < 0.3 and 0.5 < float(got.max()) <= 1.0
    assert (tbr.UNC_LOG_MIN, tbr.UNC_LOG_MAX) == (jbr.UNC_LOG_MIN,
                                                  jbr.UNC_LOG_MAX)


# ---- the Hessian ------------------------------------------------------------

def _check_hessian(preset, channel, arm):
    jm, tm, jp, tp = _models(preset)
    rays = [_rays(s) for s in (1, 2)]
    ref = jbr.ComputeUncertainty(jp, jm, lod=LOD, channel=channel).run(
        [jax_bundle(r) for r in rays])
    got = tbr.ComputeUncertainty(tp, tm, lod=LOD, channel=channel,
                                 compute_dtype=arm.dtype).run(
        [torch_bundle(r) for r in rays])
    assert got.dtype == np.float32 and got.shape == (CELLS,)
    assert (got >= 0).all() and got.max() > 0
    assert np.array_equal(got > 0, ref > 0) or arm.name == "bf16"
    l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert l2 <= GRID_L2[arm.name], (preset, channel, l2)
    assert _hot_overlap(got, ref) >= 0.9
    if preset == "cropnerf" and arm.name == "f32":
        assert np.abs(got - ref).max() <= 1e-4 * ref.max()
    assert all(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("preset", PRESETS)
def test_hessian_matches_jax(preset, arm):
    """Two bundles of 16 rays at lod 4, the semantics channel."""
    _check_hessian(preset, "semantics", arm)


@pytest.mark.parametrize("preset", PRESETS)
def test_hessian_rgb_channel_matches_jax(preset, monkeypatch):
    """The rgb channel (three gradients, JAX's jacrev), in the f32 arm."""
    from torch_parity import ARM_TOL, Arm
    monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    jax.clear_caches()
    try:
        _check_hessian(preset, "rgb", Arm("f32", torch.float32,
                                          ARM_TOL["f32"]))
    finally:
        jax.clear_caches()


def test_hessian_pass_freezes_the_parameters(monkeypatch, tmp_path):
    """The field runs with every parameter's requires_grad off (so the
    kernels' backwards compute dx alone) and the flags come back; run()
    saves unc.npy as float32 [(2^lod+1)^3]."""
    _, tm, _, tp = _models("cropnerf-mxu")
    seen = []
    field_density = tbr.field_density

    def spy(field, *args, **kwargs):
        seen.append(any(p.requires_grad for p in tp.parameters()))
        return field_density(field, *args, **kwargs)

    monkeypatch.setattr(tbr, "field_density", spy)
    path = tmp_path / "unc.npy"
    h = tbr.ComputeUncertainty(tp, tm, lod=2).run(
        [torch_bundle(_rays(3))], save_path=path)
    assert seen == [False]
    assert all(p.requires_grad for p in tp.parameters())
    saved = np.load(path)
    assert saved.dtype == np.float32 and saved.shape == (125,)
    np.testing.assert_array_equal(saved, h)


def test_bank_ray_batches_draw_collided_bundles():
    from cropnerf_tpu_torch.core.cameras import generate_rays
    from cropnerf_tpu_torch.data.databank import (build_pixel_bank,
                                                  decode_pixel_index)
    cams = TorchCameras(**{k: torch.from_numpy(v)
                           for k, v in _camera_arrays().items()})
    rng = np.random.default_rng(0)
    bank = build_pixel_bank(rng.integers(0, 255, (1, H, W, 3), np.uint8),
                            np.ones((1, H, W), np.uint8), cams, device="cpu")
    m = TORCH_PRESETS["cropnerf"].model
    batches = list(tbr.bank_ray_batches(bank, m, 3, 5,
                                        torch.Generator().manual_seed(4)))
    again = list(tbr.bank_ray_batches(bank, m, 3, 5,
                                      torch.Generator().manual_seed(4)))
    assert len(batches) == 3
    idx = torch.randint(0, bank.num_pixels, (5,),
                        generator=torch.Generator().manual_seed(4))
    origins, dirs = generate_rays(cams, *decode_pixel_index(idx, H, W))
    torch.testing.assert_close(batches[0].directions, dirs)
    torch.testing.assert_close(batches[0].origins, origins)
    for a, b in zip(batches, again):
        assert torch.equal(a.directions, b.directions)
        assert a.num_rays == 5
        assert torch.all(a.nears == m.near_plane)
        assert torch.all(a.fars == m.far_plane)


# ---- the filtered paths -----------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 1.0])
@pytest.mark.parametrize("preset", PRESETS)
def test_render_uncertainty_matches_jax(preset, threshold, arm):
    jm, tm, jp, tp = _models(preset)
    grid, rays = _grid(1), _rays(4)
    ref = jax.jit(functools.partial(
        jbr.render_uncertainty, cfg=jm, lod=LOD, n_samples=N_SAMPLES,
        density_threshold=threshold))(jp, jax_bundle(rays),
                                      hessian=jnp.asarray(grid))
    got = tbr.render_uncertainty(tp, torch_bundle(rays), tm, grid, LOD,
                                 N_SAMPLES, density_threshold=threshold,
                                 compute_dtype=arm.dtype)
    assert got.shape == (N_RAYS,)
    assert_close(got, ref, arm.tol, "per-ray uncertainty")
    if threshold is not None:
        unfiltered = tbr.render_uncertainty(tp, torch_bundle(rays), tm, grid,
                                            LOD, N_SAMPLES,
                                            compute_dtype=arm.dtype)
        assert not torch.allclose(got, unfiltered)


@pytest.mark.parametrize("preset", PRESETS)
def test_forward_with_density_hook_matches_jax(preset, arm):
    """The uncertainty filter at threshold 0.5 wraps every proposal density
    and the field density."""
    jm, tm, jp, tp = _models(preset)
    grid, rays = _grid(2), _rays(5)
    jhook = jbr.make_uncertainty_density_hook(jnp.asarray(grid), jm, LOD,
                                              N_SAMPLES)
    ref = jax.jit(lambda p, rb: jmodel.forward(
        p, rb, jm, density_hook=lambda x, d: jhook(x, d, 0.5)))(
        jp, jax_bundle(rays))
    thook = tbr.make_uncertainty_density_hook(grid, tm, LOD, N_SAMPLES)
    got = tmodel.forward(tp, torch_bundle(rays), tm, compute_dtype=arm.dtype,
                         density_hook=lambda x, d: thook(x, d, 0.5))
    plain = tmodel.forward(tp, torch_bundle(rays), tm, compute_dtype=arm.dtype)
    for k in ("rgb", "accumulation", "semantics"):
        assert_close(got[k], ref[k], arm.tol, k)
    for i in range(3):
        assert_close(got["weights_list"][i], ref["weights_list"][i], arm.tol,
                     f"weights {i}")
    assert not torch.allclose(got["accumulation"], plain["accumulation"])


def test_render_fn_with_density_hook_matches_jax(monkeypatch):
    """An 8x8 cropnerf-mxu image in 32-ray chunks through the filter with
    hook_arg 0.5 (f32 arm); hook_arg 1.0 keeps every sample."""
    monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    jax.clear_caches()
    try:
        jcfg = dataclasses.replace(reduced_mxu(JAX_PRESETS),
                                   eval_num_rays_per_chunk=32)
        tcfg = dataclasses.replace(reduced_mxu(TORCH_PRESETS),
                                   eval_num_rays_per_chunk=32)
        jp, tp = jax_and_torch_params(jcfg.model, num_images=1)
        grid, cams = _grid(3), _camera_arrays()
        jhook = jbr.make_uncertainty_density_hook(jnp.asarray(grid),
                                                  jcfg.model, LOD, N_SAMPLES)
        ref = jax_make_render_fn(jcfg, density_hook=jhook)(
            jp, JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()}),
            0, H, W, 0.5)
        thook = tbr.make_uncertainty_density_hook(grid, tcfg.model, LOD,
                                                  N_SAMPLES)
        render = make_render_fn(tcfg, compute_dtype=torch.float32,
                                density_hook=thook)
        tcams = TorchCameras(**{k: torch.from_numpy(v)
                                for k, v in cams.items()})
        got = render(tp, tcams, 0, H, W, 0.5)
        for k in ("rgb", "accumulation", "semantics"):
            assert got[k].shape[:2] == (H, W)
            assert_close(got[k], ref[k], 1e-4, k)
        keep_all = render(tp, tcams, 0, H, W, 1.0)
        plain = make_render_fn(tcfg, compute_dtype=torch.float32)(
            tp, tcams, 0, H, W)
        assert torch.equal(keep_all["accumulation"], plain["accumulation"])
        assert not torch.allclose(got["accumulation"], plain["accumulation"])
    finally:
        jax.clear_caches()
