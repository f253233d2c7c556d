"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA device is visible (decided in
a fixture).  The machine with the card has no JAX, so run this file without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: the kernel and the plain version round the same operands to bf16
and sum in float32 in another order, so their outputs agree to bf16
rounding carried through the layers: max |kernel - plain| <= 1e-2 ·
max |plain| for outputs, 5e-2 · max |plain| for weight and bias gradients
(the plain version's autograd rounds cotangents to bf16 where the kernel
keeps them in float32).  The per-row gradients dx and dextras are held
row by row: a relu unit whose pre-activation lies within one bf16 rounding
of zero may take the other side in either version, and moves that row's
gradient by up to ~10 % of the largest; both versions are equally far from
a float32 computation (PERF.md, Findings).  So dx and dextras must agree within
5e-2 · max |plain| on 99 % of rows and to 5e-2 in relative L2 norm.
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
BWD_TOL = 5e-2   # gradients: bf16 products, f32 cotangents, other sum order
ROW_SHARE = 0.99  # per-row gradients (dx, dextras): rows within BWD_TOL


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
    """float32 compute runs only on the CPU; K2 and K3 have no backward
    kernel yet and refuse to record a graph (K1 records one)."""
    cfg, params = _field(cuda)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    x, extras = _field_inputs(256, color[1].shape[0], cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        kfield.fused_pe_density(x, base, top, POS_FREQS, torch.float32)
    with pytest.raises(RuntimeError, match="slice 7"):
        kfield.fused_pe_density(x, base, top, POS_FREQS)
    heads = [params.field.mlp_semantic.w[0], params.field.mlp_semantic.b[0]
             .reshape(1, -1), params.field.mlp_semantic.w[1],
             params.field.mlp_semantic.b[1].reshape(1, -1)]
    with pytest.raises(RuntimeError, match="slice 5"):
        kmlp.fused_mlp(x[:, :1].expand(256, 15).contiguous(), heads)
    t, _, _ = kfield.fused_pe_nerf(x, extras, base, top, color, sem,
                                   POS_FREQS)
    assert t.requires_grad


def _grads(outs, inputs, cots):
    return torch.autograd.grad(outs, inputs, cots)


def _grad_agrees(got, ref, per_row: bool) -> bool:
    if not per_row:
        return _rel_err(got, ref) <= BWD_TOL
    row_err = (got - ref).abs().amax(dim=1) / ref.abs().max()
    l2 = ((got - ref).norm() / ref.norm()).item()
    return (row_err <= BWD_TOL).float().mean().item() >= ROW_SHARE and l2 <= BWD_TOL


@pytest.mark.parametrize("pass_sem", [False, True])
@pytest.mark.parametrize("n", [128, 1000, 196_608 - 77])
def test_fused_pe_nerf_backward_kernel_matches_plain(cuda, n, pass_sem):
    cfg, params = _field(cuda)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    x, extras = _field_inputs(n, color[1].shape[0], cuda)
    x.requires_grad_(True)
    extras.requires_grad_(True)
    wbs = [*base, *top, *color, *sem]
    g = torch.Generator(device=cuda).manual_seed(5)
    cots = [torch.randn((n, c), generator=g, device=cuda) for c in (16, 3, 1)]
    before = (kfield.fused_pe_nerf.launches, kfield.fused_pe_nerf_bwd.launches)
    got = _grads(kfield.fused_pe_nerf(x, extras, base, top, color, sem,
                                      POS_FREQS, pass_sem_grad=pass_sem),
                 [x, extras, *wbs], cots)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_nerf.launches,
            kfield.fused_pe_nerf_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = _grads(kfield.fused_pe_nerf_plain(x, extras, base, top, color, sem,
                                            POS_FREQS, pass_sem_grad=pass_sem),
                 [x, extras, *wbs], cots)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _grad_agrees(a, b, per_row=i < 2), (i, _rel_err(a, b))
    again = _grads(kfield.fused_pe_nerf(x, extras, base, top, color, sem,
                                        POS_FREQS, pass_sem_grad=pass_sem),
                   [x, extras, *wbs], cots)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"


def _synthetic_bank(cuda, n_img=4, h=120, w=160):
    import numpy as np
    from cropnerf_tpu_torch.core.cameras import Cameras
    from cropnerf_tpu_torch.data.databank import build_pixel_bank
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (n_img, h, w, 3), dtype=np.uint8)
    masks = (rng.rand(n_img, h, w) > 0.9).astype(np.uint8)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n_img, 1, 1))
    c2w[:, :, 3] = rng.randn(n_img, 3) * 0.5
    full = lambda v: torch.full((n_img,), v, device=cuda)  # noqa: E731
    cams = Cameras(c2w=torch.from_numpy(c2w).to(cuda), fx=full(150.0),
                   fy=full(150.0), cx=full(w / 2.0), cy=full(h / 2.0),
                   width=full(w).long(), height=full(h).long())
    return build_pixel_bank(images, masks, cams, device=cuda)


def test_train_step_kernel_path_matches_plain_path(cuda):
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import train_loss
    cfg = dataclasses.replace(PRESETS["cropnerf-mxu"],
                              train_num_rays_per_batch=1024)
    plain = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, field=dataclasses.replace(cfg.model.field,
                                             mlp_impl="xla")))
    bank = _synthetic_bank(cuda)
    results = []
    for c in (cfg, plain):
        state = create_train_state(c, bank.num_images,
                                   torch.Generator().manual_seed(0), cuda)
        gen = torch.Generator(device=cuda).manual_seed(1)
        idx = torch.randint(0, bank.num_pixels, (1024,), generator=gen,
                            device=cuda)
        before = kfield.fused_pe_nerf_bwd.launches
        loss, _ = train_loss(state.params, bank, idx, 300, c, gen)
        loss.backward()
        launched = kfield.fused_pe_nerf_bwd.launches - before
        assert launched == (1 if c is cfg else 0)
        results.append((loss.detach(), {k: p.grad.clone() for k, p in
                                        state.params.named_parameters()}))
    (l_k, g_k), (l_p, g_p) = results
    assert torch.isfinite(l_k) and abs(l_k - l_p) <= 2e-2 * abs(l_p)
    for k in g_p:
        assert torch.isfinite(g_k[k]).all(), k
        assert _rel_err(g_k[k], g_p[k]) <= BWD_TOL, (k, _rel_err(g_k[k], g_p[k]))


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
