"""The PyTorch port's chunked renderer and volume export against the JAX
package on a reduced cropnerf-mxu (full widths, 32 and 16 proposal
samples then 8)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.core.cameras import Cameras as JaxCameras
from cropnerf_tpu.export import volume as jvolume
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.train.step import make_render_fn as jax_make_render_fn
from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
from cropnerf_tpu_torch.export import volume as tvolume
from cropnerf_tpu_torch.export.ply import read_ply
from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
from cropnerf_tpu_torch.train.step import make_render_fn
from torch_parity import (ARM_TOL, Arm, arm, assert_close,  # noqa: F401
                          jax_and_torch_params, reduced_mxu)

H = W = 8


def _camera_arrays():
    c2w = np.eye(3, 4, dtype=np.float32)[None].copy()
    c2w[0, :, 3] = [0.1, -0.05, 1.5]
    return dict(c2w=c2w, fx=np.float32([7.0]), fy=np.float32([7.5]),
                cx=np.float32([W / 2]), cy=np.float32([H / 2]),
                width=np.int32([W]), height=np.int32([H]),
                distortion=np.float32([[0.08, -0.02, 0.004, 0.0, 0.003,
                                        -0.002]]))


def _check_render(chunk, arm):
    jcfg = dataclasses.replace(reduced_mxu(JAX_PRESETS),
                               eval_num_rays_per_chunk=chunk)
    tcfg = dataclasses.replace(reduced_mxu(TORCH_PRESETS),
                               eval_num_rays_per_chunk=chunk)
    params, tp = jax_and_torch_params(jcfg.model, num_images=1)
    cams = _camera_arrays()
    ref = jax_make_render_fn(jcfg)(
        params, JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()}),
        0, H, W)
    got = make_render_fn(tcfg, compute_dtype=arm.dtype)(
        tp, TorchCameras(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        0, H, W)
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap"):
        assert got[k].shape[:2] == (H, W)
        assert_close(got[k], ref[k], arm.tol, k)
    same_depth = np.isclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                            atol=arm.tol, rtol=arm.tol)
    assert same_depth.mean() >= (1.0 if arm.name == "f32" else 0.9)


def test_render_matches_jax(arm):
    """8x8 image with lens distortion, 64 rays in chunks of 32."""
    _check_render(32, arm)


def test_render_pads_the_last_chunk(monkeypatch):
    """64 rays in chunks of 24: the last chunk is padded (f32 arm)."""
    monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    jax.clear_caches()
    try:
        _check_render(24, Arm("f32", torch.float32, ARM_TOL["f32"]))
    finally:
        jax.clear_caches()


def test_camera_ray_grid_matches_jax():
    """Pixel-centre rays through a distorted pinhole camera (3 undistortion
    iterations), the whole 8x8 grid."""
    from cropnerf_tpu.core.cameras import camera_ray_grid as jax_grid
    from cropnerf_tpu_torch.core.cameras import camera_ray_grid
    cams = _camera_arrays()
    ref = jax_grid(JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()}),
                   0, H, W)
    got = camera_ray_grid(
        TorchCameras(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        0, H, W)
    for name, g, r in zip(("origins", "directions"), got, ref):
        assert_close(g, r, 1e-6, name)


def test_ray_aabb_intersect_matches_jax():
    """Hits, misses, rays starting inside the box and axis-parallel rays."""
    from cropnerf_tpu.core.cameras import ray_aabb_intersect as jax_isect
    from cropnerf_tpu_torch.core.cameras import ray_aabb_intersect
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d[:8] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    box = np.array([[-1, -0.5, -0.8], [1, 0.5, 0.8]], np.float32)
    ref = jax_isect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(box), 0.05)
    got = ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(box), 0.05)
    assert 0 < float(np.asarray(ref[2]).sum()) < 64
    for name, g, r in zip(("nears", "fars", "hit"), got, ref):
        assert_close(g, r, 1e-6, name)


@pytest.mark.parametrize("background", ["last_sample", "black", "color"])
def test_render_rgb_backgrounds_match_jax(background):
    from cropnerf_tpu.ops import render as jrender
    from cropnerf_tpu_torch.ops import render as trender
    rng = np.random.default_rng(6)
    w = rng.uniform(0, 0.2, (16, 9)).astype(np.float32)
    rgb = rng.uniform(0, 1, (16, 9, 3)).astype(np.float32)
    color = np.float32([0.2, 0.5, 0.9])
    ref = jrender.render_rgb(jnp.asarray(w), jnp.asarray(rgb), background,
                             jnp.asarray(color))
    got = trender.render_rgb(torch.from_numpy(w), torch.from_numpy(rgb),
                             background, torch.from_numpy(color))
    assert_close(got, ref, 1e-6, background)


def test_orthographic_grid_and_unscale_match_jax():
    for n, axis in ((6, 2), (9, 0)):
        ref = jvolume.orthographic_ray_grid(AABB, n, axis)
        got = tvolume.orthographic_ray_grid(AABB, n, axis)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    pts = np.random.default_rng(7).standard_normal((10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvolume.unscale_points(pts, 4.0),
                                  jvolume.unscale_points(pts, 4.0))


AABB = np.array([[-0.6, -0.5, -0.4], [0.6, 0.5, 0.4]], np.float32)
EXPORT = dict(num_points_per_side=6, rays_per_batch=16, num_samples=8,
              render_rgb=True, seed=3, semantic_threshold=0.0,
              density_threshold=1.0, colormap_threshold=0.5)


def _jax_chunk_noise(seed, B, S):
    """The JAX export's per-chunk jitter: fold_in(PRNGKey(seed), c) →
    uniform [B, S+1] (export/volume.py, ops/pdf.py sample_spaced)."""
    key = jax.random.PRNGKey(seed)

    def noise(c):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, c), (B, S + 1))))
    return noise


def test_sample_volume_matches_jax(arm):
    jcfg = reduced_mxu(JAX_PRESETS).model
    tcfg = reduced_mxu(TORCH_PRESETS).model
    params, tp = jax_and_torch_params(jcfg, num_images=2)
    ref = jvolume.sample_volume(params, jcfg, AABB, **EXPORT)
    got = tvolume.sample_volume(
        tp, tcfg, AABB, compute_dtype=arm.dtype,
        chunk_noise=_jax_chunk_noise(EXPORT["seed"], EXPORT["rays_per_batch"],
                                     EXPORT["num_samples"]), **EXPORT)
    # 9 x 7 rays in chunks of 16 (the last one padded), 8 samples each
    n_density = ref["density"].points.shape[0]
    assert 0 < ref["semantic"].points.shape[0] < n_density < 63 * 8
    for name in ("semantic", "semantic_colormap", "density"):
        r, g = ref[name], got[name]
        if arm.name == "f32":       # point for point
            assert g.points.shape == r.points.shape, name
            assert_close(g.points, r.points, 1e-5, f"{name} points")
            assert_close(g.colors, r.colors, arm.tol, f"{name} colors")
            assert_close(g.alpha, r.alpha, arm.tol, f"{name} alpha")
        else:                       # a sample at a threshold may flip
            n_ref, n_got = r.points.shape[0], g.points.shape[0]
            assert abs(n_ref - n_got) <= 2 + 0.05 * n_ref, (name, n_ref, n_got)


def test_export_and_write_writes_three_clouds(tmp_path):
    tcfg = reduced_mxu(TORCH_PRESETS).model
    _, tp = jax_and_torch_params(reduced_mxu(JAX_PRESETS).model, num_images=2)
    clouds = tvolume.sample_volume(tp, tcfg, AABB, **EXPORT)
    paths = tvolume.export_and_write(tp, tcfg, AABB, tmp_path / "exports",
                                     dataparser_scale=4.0, **EXPORT)
    assert sorted(paths) == ["density", "semantic", "semantic_colormap"]
    for name, path in paths.items():
        pts, colors = read_ply(path)
        assert pts.shape == clouds[name].points.shape
        np.testing.assert_allclose(pts, clouds[name].points * 0.5, rtol=1e-6)
        assert colors.shape == pts.shape and colors.dtype == np.uint8
