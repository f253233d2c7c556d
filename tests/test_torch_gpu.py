"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA device is visible (decided in
a fixture).  The machine with the card has no JAX, so run this file without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: the kernel and the plain version round the same operands to bf16
and sum in float32 in another order, so their outputs agree to bf16
rounding carried through the layers: max |kernel - plain| <= 1e-2 ·
max |plain|.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.models.model import model_init
from cropnerf_tpu_torch.models.vanilla import POS_FREQS, fused_field_weights
from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield

pytestmark = pytest.mark.gpu
TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def _field(cuda, **field_changes):
    cfg = PRESETS["cropnerf-mxu"].model
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                             **field_changes))
    params = model_init(cfg, 8, torch.Generator().manual_seed(0), cuda)
    return cfg, params


def _field_inputs(n, de, cuda, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.rand((n, 3), generator=g, device=cuda) * 2 - 1
    extras = torch.randn((n, de), generator=g, device=cuda) * 0.5
    return x, extras


@pytest.mark.parametrize("n", [128, 1000, 196_608 - 77])
@torch.no_grad()
def test_fused_pe_nerf_kernel_matches_plain(cuda, n):
    cfg, params = _field(cuda)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    x, extras = _field_inputs(n, color[1].shape[0], cuda)
    before = kfield.fused_pe_nerf.launches
    got = kfield.fused_pe_nerf(x, extras, base, top, color, sem, POS_FREQS)
    torch.cuda.synchronize()
    assert kfield.fused_pe_nerf.launches == before + 1
    ref = kfield.fused_pe_nerf_plain(x, extras, base, top, color, sem,
                                     POS_FREQS)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= TOL, (name, _rel_err(g, r))


@pytest.mark.parametrize("n", [128, 65_536 - 45])
@pytest.mark.parametrize("hidden", [256, 64])
@torch.no_grad()
def test_fused_pe_density_kernel_matches_plain(cuda, n, hidden):
    cfg, params = _field(cuda, hidden_dim=hidden)
    base, top, _, _ = fused_field_weights(params.field, cfg.field)
    x, _ = _field_inputs(n, 1, cuda, seed=2)
    before = kfield.fused_pe_density.launches
    got = kfield.fused_pe_density(x, base, top, POS_FREQS)
    torch.cuda.synchronize()
    assert kfield.fused_pe_density.launches == before + 1
    ref = kfield.fused_pe_density_plain(x, base, top, POS_FREQS)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("dims", [(15, 64, 1), (74, 64, 3), (15, 128, 1),
                                  (63, 256, 256, 16)])
@pytest.mark.parametrize("n", [127, 65_536 - 3])
@torch.no_grad()
def test_fused_mlp_kernel_matches_plain(cuda, dims, n):
    g = torch.Generator(device=cuda).manual_seed(3)
    wbs = []
    for i in range(len(dims) - 1):
        wbs.append(torch.randn((dims[i], dims[i + 1]), generator=g,
                               device=cuda) / dims[i] ** 0.5)
        wbs.append(torch.randn((1, dims[i + 1]), generator=g, device=cuda)
                   * 0.05)
    x = torch.randn((n, dims[0]), generator=g, device=cuda)
    before = kmlp.fused_mlp.launches
    got = kmlp.fused_mlp(x, wbs)
    torch.cuda.synchronize()
    assert kmlp.fused_mlp.launches == before + 1
    ref = kmlp.fused_mlp_plain(x, wbs)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL


def test_kernels_refuse_float32_and_autograd(cuda):
    cfg, params = _field(cuda)
    base, top, _, _ = fused_field_weights(params.field, cfg.field)
    x, _ = _field_inputs(256, 1, cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        kfield.fused_pe_density(x, base, top, POS_FREQS, torch.float32)
    with pytest.raises(RuntimeError, match="backward"):
        kfield.fused_pe_density(x, base, top, POS_FREQS)


@torch.no_grad()
def test_forward_kernel_path_matches_plain_path(cuda):
    from cropnerf_tpu_torch.core.rays import RayBundle
    from cropnerf_tpu_torch.models.model import forward
    cfg, params = _field(cuda)
    plain_cfg = dataclasses.replace(
        cfg, field=dataclasses.replace(cfg.field, mlp_impl="xla"))
    g = torch.Generator(device=cuda).manual_seed(4)
    n = 512
    d = torch.randn((n, 3), generator=g, device=cuda)
    rb = RayBundle(origins=torch.tensor([[0.0, 0.0, 1.5]], device=cuda)
                   .expand(n, 3), directions=d / d.norm(dim=-1, keepdim=True),
                   nears=torch.full((n,), 0.05, device=cuda),
                   fars=torch.full((n,), 1000.0, device=cuda),
                   camera_idx=torch.zeros((n,), dtype=torch.long, device=cuda))
    got = forward(params, rb, cfg)
    ref = forward(params, rb, plain_cfg)
    for k in ("rgb", "accumulation", "semantics"):
        assert torch.isfinite(got[k]).all(), k
        assert _rel_err(got[k], ref[k]) <= 2 * TOL, (k, _rel_err(got[k], ref[k]))
    same = (got["depth"] - ref["depth"]).abs() <= 1e-3 * ref["depth"].abs() + 1e-4
    assert same.float().mean() >= 0.99
