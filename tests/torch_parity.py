"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both sides get identical inputs made with numpy from a seed and pass data
as numpy arrays.  Each comparison runs in two arms:

* ``f32``: JAX with ``CROPNERF_FP32_MATMUL=1``, the port with
  ``compute_dtype=torch.float32``.  The arithmetic is the same up to
  summation order, so the tolerance is 1e-4.
* ``bf16``: both at their bf16 default.  The two frameworks may round an
  operand to a neighbouring bf16 value where float32 sums differ in the
  last bit, and such flips carry through the later layers; 2e-2 bounds it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ARM_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
ARM_TOL = {"f32": 1e-4, "bf16": 2e-2}


@dataclasses.dataclass
class Arm:
    name: str
    dtype: torch.dtype
    tol: float


@pytest.fixture(params=["f32", "bf16"])
def arm(request, monkeypatch):
    """Sets the JAX compute dtype for one arm.  The JAX package reads
    CROPNERF_FP32_MATMUL while tracing, so compiled programs are dropped
    before and after, and no other test reuses one traced in this arm."""
    if request.param == "f32":
        monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    else:
        monkeypatch.delenv("CROPNERF_FP32_MATMUL", raising=False)
    jax.clear_caches()
    yield Arm(request.param, ARM_DTYPE[request.param], ARM_TOL[request.param])
    jax.clear_caches()


def np_wbs(rng: np.random.Generator, dims, scale: float = 1.0):
    """[W0, b0, W1, b1, ...] with W ~ N(0, scale²/fan_in), b [1, d]."""
    out = []
    for i in range(len(dims) - 1):
        out.append((rng.standard_normal((dims[i], dims[i + 1]))
                    * scale / np.sqrt(dims[i])).astype(np.float32))
        out.append((rng.standard_normal((1, dims[i + 1])) * 0.05)
                   .astype(np.float32))
    return out


def to_jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def to_torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def assert_close(got, ref, tol: float, what: str = "") -> None:
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol, err_msg=what)


def reduced_mxu(presets, preset="cropnerf-mxu", **model_changes):
    """The cropnerf-mxu preset (or another of its family) at full widths
    with few samples: 32 and 16 proposal samples, then 8 field samples per
    ray."""
    cfg = presets[preset]
    changes = dict(num_nerf_samples_per_ray=8,
                   num_proposal_samples_per_ray=(32, 16))
    changes.update(model_changes)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **changes))


def reduced_cropnerf(presets, **model_changes):
    """The cropnerf preset (the hash-grid field) at full MLP widths with a
    small field grid of dense and hashed levels (4 levels, 2^12 rows,
    resolutions 4, 8, 16, 32: the first two dense), 3-level 2^10-row
    proposal grids and 32, 16 then 8 samples per ray."""
    cfg = presets["cropnerf"]
    m = cfg.model
    field = dataclasses.replace(m.field, grid=dataclasses.replace(
        m.field.grid, num_levels=4, log2_hashmap_size=12, min_res=4,
        max_res=32))
    props = tuple(dataclasses.replace(p, grid=dataclasses.replace(
        p.grid, num_levels=3, log2_hashmap_size=10))
        for p in m.proposal_fields)
    changes = dict(field=field, proposal_fields=props,
                   num_nerf_samples_per_ray=8,
                   num_proposal_samples_per_ray=(32, 16))
    changes.update(model_changes)
    return dataclasses.replace(cfg, model=dataclasses.replace(m, **changes))


def ray_arrays(n_rays: int, seed: int = 0, near: float = 0.05,
               far: float = 1000.0):
    """The entry() rays: origin (0, 0, 1.5), random unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.0, 1.5]], np.float32), (n_rays, 1))
    return dict(origins=o, directions=d,
                nears=np.full((n_rays,), near, np.float32),
                fars=np.full((n_rays,), far, np.float32),
                camera_idx=np.arange(n_rays, dtype=np.int32) % 4)


def jax_bundle(rays):
    from cropnerf_tpu.core.rays import RayBundle
    return RayBundle(**{k: jnp.asarray(v) for k, v in rays.items()})


def torch_bundle(rays):
    from cropnerf_tpu_torch.core.rays import RayBundle
    t = {k: torch.from_numpy(v) for k, v in rays.items()}
    t["camera_idx"] = t["camera_idx"].long()
    return RayBundle(**t)


def jax_and_torch_params(jax_cfg, num_images: int = 4, seed: int = 0):
    """JAX params from model_init and the port's copy via params_from_jax."""
    from cropnerf_tpu.models.model import model_init
    from cropnerf_tpu_torch.convert import params_from_jax
    params = model_init(jax.random.PRNGKey(seed), jax_cfg, num_images)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(tree, device="cpu")
