"""The PyTorch port's model against the JAX package on a reduced
cropnerf-mxu (full widths, 64 rays, 32 and 16 proposal samples then 8),
plus the port's structural rules: the presets are a faithful copy and no
module of the port imports JAX or the JAX package."""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.models import model as jmodel
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.ops import pdf as jpdf
from cropnerf_tpu.ops import render as jrender
from cropnerf_tpu_torch.models import model as tmodel
from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
from cropnerf_tpu_torch.ops import pdf as tpdf
from cropnerf_tpu_torch.ops import render as trender
from torch_parity import (arm, assert_close, jax_and_torch_params,  # noqa: F401
                          jax_bundle, ray_arrays, reduced_mxu, torch_bundle)

REPO = Path(__file__).resolve().parents[1]
N_RAYS = 64


def test_presets_equal_jax_presets_field_for_field():
    assert list(TORCH_PRESETS) == list(JAX_PRESETS)
    for name in JAX_PRESETS:
        assert (dataclasses.asdict(TORCH_PRESETS[name])
                == dataclasses.asdict(JAX_PRESETS[name])), name
        assert (TORCH_PRESETS[name].model.num_proposal_iterations
                == JAX_PRESETS[name].model.num_proposal_iterations)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "cropnerf_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
              "cropnerf_tpu"}
    for f in files:
        bad = banned.intersection(_imported_roots(f))
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    from cropnerf_tpu_torch.convert import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TORCH_PRESETS["cropnerf-mxu"].model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.model_init(cfg, 2, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"field": {}}, device="cuda")
    params = tmodel.model_init(cfg, 2, torch.Generator().manual_seed(0),
                               device="cpu")
    assert params.camera_opt.device.type == "cpu"


def test_params_from_jax_keeps_the_tree():
    cfg = reduced_mxu(JAX_PRESETS).model
    params, tp = jax_and_torch_params(cfg)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    state = tp.state_dict()
    assert len(state) == len(flat)
    for key, value in flat.items():
        name = ".".join(key.replace("['", ".").replace("']", "")
                        .replace("[", ".").replace("]", "").split(".")[1:])
        np.testing.assert_array_equal(state[name].numpy(), value, name)
    # model_init builds the same tree shape from a torch.Generator
    fresh = tmodel.model_init(reduced_mxu(TORCH_PRESETS).model, 4,
                              torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in state.items()}


def test_forward_matches_jax(arm):
    jcfg = reduced_mxu(JAX_PRESETS).model
    tcfg = reduced_mxu(TORCH_PRESETS).model
    params, tp = jax_and_torch_params(jcfg)
    rays = ray_arrays(N_RAYS)
    ref = jax.jit(lambda p, rb: jmodel.forward(p, rb, jcfg))(
        params, jax_bundle(rays))
    got = tmodel.forward(tp, torch_bundle(rays), tcfg,
                         compute_dtype=arm.dtype)
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap",
              "prop_depth_0", "prop_depth_1"):
        assert_close(got[k], ref[k], arm.tol, k)
    for i in range(3):
        assert_close(got["weights_list"][i], ref["weights_list"][i], arm.tol,
                     f"weights {i}")
        assert_close(got["sdist_list"][i], ref["sdist_list"][i], arm.tol,
                     f"sdist {i}")
    same_depth = np.isclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                            atol=arm.tol, rtol=arm.tol)
    # the median sample can move where a cumulative weight sits at 0.5
    assert same_depth.mean() >= (1.0 if arm.name == "f32" else 0.9)


def test_forward_masks_invalid_rays():
    tcfg = reduced_mxu(TORCH_PRESETS).model
    _, tp = jax_and_torch_params(reduced_mxu(JAX_PRESETS).model)
    rb = torch_bundle(ray_arrays(8))
    rb.mask = torch.tensor([1, 0, 1, 0, 1, 1, 0, 1], dtype=torch.float32)
    out = tmodel.forward(tp, rb, tcfg)
    assert torch.all(out["rgb"][rb.mask == 0] == 0)
    assert torch.all(out["accumulation"][rb.mask == 1] > 0)


def test_forward_export_matches_jax(arm):
    jcfg = reduced_mxu(JAX_PRESETS).model
    tcfg = reduced_mxu(TORCH_PRESETS).model
    params, tp = jax_and_torch_params(jcfg)
    rays = ray_arrays(N_RAYS, seed=1, near=0.0, far=2.0)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    S = 8
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, rb: jmodel.forward_export(
        p, rb, jcfg, S, jnp.asarray(aabb), key=key,
        render_rgb_samples=True))(params, jax_bundle(rays))
    noise = np.array(jax.random.uniform(key, (N_RAYS, S + 1)))
    got = tmodel.forward_export(tp, torch_bundle(rays), tcfg, S,
                                torch.from_numpy(aabb), True,
                                noise=torch.from_numpy(noise),
                                compute_dtype=arm.dtype)
    assert_close(got["point_location"], ref["point_location"], 1e-5, "pos")
    for k in ("semantics", "rgb"):
        assert_close(got[k], ref[k], arm.tol, k)
    # density = exp(raw) reaches ~1e3 here: compare its logarithm
    assert_close(torch.log(got["density"]), np.log(np.asarray(ref["density"])),
                 arm.tol, "log density")


def test_forward_accumulation_matches_jax(arm):
    jcfg = reduced_mxu(JAX_PRESETS).model
    tcfg = reduced_mxu(TORCH_PRESETS).model
    params, tp = jax_and_torch_params(jcfg)
    rays = ray_arrays(N_RAYS, seed=2)
    rays_mask = (np.arange(N_RAYS) % 3 != 0).astype(np.float32)
    ref = jax.jit(lambda p, rb: jmodel.forward_accumulation(p, rb, jcfg))(
        params, jax_bundle({**rays, "mask": rays_mask}))
    rb = torch_bundle(rays)
    rb.mask = torch.from_numpy(rays_mask)
    got = tmodel.forward_accumulation(tp, rb, tcfg, compute_dtype=arm.dtype)
    assert_close(got, ref, arm.tol, "accumulation")


def test_anneal_factor_matches_jax():
    cfg = JAX_PRESETS["cropnerf-mxu"].model
    for step in (0, 1, 250, 999, 1000, 5000):
        np.testing.assert_allclose(
            tmodel.anneal_factor(step, cfg).item(),
            float(jmodel.anneal_factor(jnp.asarray(step), cfg)), rtol=1e-6)


def _pdf_case(rng, R=16, S=12):
    bins = np.sort(rng.uniform(0, 1, (R, S + 1)), axis=-1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 1, (R, S)).astype(np.float32)
    w[rng.uniform(size=(R, S)) < 0.4] = 0.0          # zero-weight bins: ties
    w[0] = 0.0                                        # an all-zero ray
    w[1, :-1] = 0.0                                   # all weight in one bin
    return bins, w


@pytest.mark.parametrize("padding", [0.0, 0.01])
@pytest.mark.parametrize("train", [False, True])
def test_sample_pdf_ties_match_masked_search(padding, train):
    """searchsorted(right=True) picks the bins the JAX masked min/max picks,
    where zero-weight bins repeat a cdf value and where it clips at 1."""
    rng = np.random.default_rng(7)
    bins, w = _pdf_case(rng)
    R, nb = w.shape[0], 21
    rays = {"origins": np.zeros((R, 3), np.float32),
            "directions": np.tile(np.float32([[0, 0, 1]]), (R, 1)),
            "nears": np.full((R,), 0.05, np.float32),
            "fars": np.full((R,), 10.0, np.float32),
            "camera_idx": np.zeros((R,), np.int32)}
    # weights scaled past 1 so the cdf saturates at the clip
    w_in = w * 3.0
    key = jax.random.PRNGKey(3)
    spacing = jpdf.spacing_piecewise()
    ref = jpdf.sample_pdf(key if train else None, jax_bundle(rays),
                          jnp.asarray(bins), jnp.asarray(w_in), nb - 1,
                          spacing, train, single_jitter=False,
                          histogram_padding=padding)
    noise = np.array(jax.random.uniform(key, (R, nb))) if train else None
    got = tpdf.sample_pdf(torch_bundle(rays), torch.from_numpy(bins),
                          torch.from_numpy(w_in), nb - 1,
                          tpdf.spacing_piecewise(), train,
                          single_jitter=False, histogram_padding=padding,
                          noise=None if noise is None else torch.from_numpy(noise))
    # a wrong bracketing bin would move a sample by a bin width (>= 1e-3
    # here); what remains is float32 rounding of the cdf, amplified where a
    # bin holds little weight
    np.testing.assert_allclose(got.spacing_starts.numpy(),
                               np.asarray(ref.spacing_starts), atol=1e-5)
    np.testing.assert_allclose(got.spacing_ends.numpy(),
                               np.asarray(ref.spacing_ends), atol=1e-5)
    np.testing.assert_allclose(got.starts.numpy(), np.asarray(ref.starts),
                               rtol=1e-5, atol=1e-5)


def test_render_depth_median_first_crossing():
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 0.2, (32, 10)).astype(np.float32)
    w[0] = 0.0                    # never crosses: last step
    w[1] = 0.05                   # crosses exactly at cumsum 0.5 (index 9)
    w[2, 3] = 0.6                 # crosses at its first big weight
    w[3, 0] = 0.5                 # crosses at index 0
    steps = np.cumsum(rng.uniform(0.1, 1, (32, 10)), axis=-1).astype(np.float32)
    ref = jrender.render_depth_median(jnp.asarray(w), jnp.asarray(steps))
    got = trender.render_depth_median(torch.from_numpy(w),
                                      torch.from_numpy(steps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, 0] == steps[0, -1] and got[3, 0] == steps[3, 0]
