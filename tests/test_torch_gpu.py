"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA device is visible (decided in
a fixture).  The machine with the card has no JAX, so run this file without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance of the MLP kernels (K1-K3; K4, the float32 hash-grid encode,
states its own above its tests): the kernel and the plain version round
the same operands to bf16 and sum in float32 in another order, so their
outputs agree to bf16 rounding carried through the layers:
max |kernel - plain| <= 1e-2 ·
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
    with pytest.raises(RuntimeError, match="slice 5"):
        kfield.fused_pe_density(x, base, top, POS_FREQS)
    heads = [params.field.mlp_semantic.w[0], params.field.mlp_semantic.b[0]
             .reshape(1, -1), params.field.mlp_semantic.w[1],
             params.field.mlp_semantic.b[1].reshape(1, -1)]
    with pytest.raises(RuntimeError, match="slice 4"):
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


# ---- K4, the hash-grid encode (csrc/hash_encode.cu) --------------------------
#
# Forward: the kernel repeats the plain version's roundings, so it agrees to
# 1e-5 of max |plain| (both sides float32).  The table gradient sums with
# atomics in another order: 1e-5.  The position gradient sums over levels
# and corners in another order: 1e-4.
HASH_TOL, DTABLE_TOL, DPOS_TOL = 1e-5, 1e-5, 1e-4

# (layout, positions, levels, log2 T, min res, max res, hash mode): the
# cropnerf path's three nets, a ragged N, a small dense [L, T, F] table and
# a hash-only packed table
HASH_CASES = {
    "field": ("packed", 196_608, 16, 19, 16, 2048, "auto"),
    "proposal0": ("packed", 1_048_576, 5, 17, 16, 128, "auto"),
    "proposal1": ("packed", 393_216, 5, 17, 16, 256, "auto"),
    "field-ragged": ("packed", 196_608 - 77, 16, 19, 16, 2048, "auto"),
    "dense-layout": ("dense", 1000, 4, 12, 4, 32, "auto"),
    "hash-mode": ("packed", 4099, 4, 12, 4, 32, "hash"),
}


def _hash_inputs(cuda, layout, n, levels, log2_t, min_res, max_res, mode,
                 seed=6):
    from cropnerf_tpu_torch.ops.hashgrid import (level_resolutions,
                                                 level_row_counts)
    res = level_resolutions(levels, min_res, max_res)
    t = 2 ** log2_t
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = ((sum(level_row_counts(res, t, mode)), 2) if layout == "packed"
             else (levels, t, 2))
    table = torch.rand(shape, generator=g, device=cuda) * 2 - 1
    pos = torch.rand((n, 3), generator=g, device=cuda)
    edges = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.5]]
                         + [[k / r, 1 - k / r, 0.5] for r in res[:3]
                            for k in range(3)], device=cuda)
    pos[:edges.shape[0]] = edges
    return table, pos, res, t


@pytest.mark.parametrize("case", list(HASH_CASES))
def test_hash_encode_kernel_matches_plain(cuda, case):
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    *shape, mode = HASH_CASES[case]
    table, pos, res, t = _hash_inputs(cuda, *shape, mode)
    cot = torch.randn((pos.shape[0], 2 * len(res)), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(7))
    grads = []
    for encode in (hashgrid.hashgrid_encode, hashgrid.hashgrid_encode_plain):
        tt = table.clone().requires_grad_(True)
        tp = pos.clone().requires_grad_(True)
        before = (khash.hash_encode.launches, khash.hash_encode_bwd.launches)
        out = encode(tt, tp, res, mode, t)
        out.backward(cot)
        torch.cuda.synchronize()
        launched = (khash.hash_encode.launches - before[0],
                    khash.hash_encode_bwd.launches - before[1])
        assert launched == ((1, 1) if encode is hashgrid.hashgrid_encode
                            else (0, 0))
        grads.append((out.detach(), tt.grad, tp.grad))
    (out, dt, dp), (ref, dt_ref, dp_ref) = grads
    assert torch.isfinite(out).all() and torch.isfinite(dt).all()
    assert _rel_err(out, ref) <= HASH_TOL, _rel_err(out, ref)
    assert _rel_err(dt, dt_ref) <= DTABLE_TOL, _rel_err(dt, dt_ref)
    assert _rel_err(dp, dp_ref) <= DPOS_TOL, _rel_err(dp, dp_ref)


def test_hash_encode_backward_without_position_gradient(cuda):
    """Positions that need no gradient take the kernel's dtable-only
    variant; the table gradient is the same."""
    from cropnerf_tpu_torch.ops import hashgrid
    table, pos, res, t = _hash_inputs(cuda, *HASH_CASES["dense-layout"])
    dts = []
    for need_pos in (False, True):
        tt = table.clone().requires_grad_(True)
        hashgrid.hashgrid_encode(tt, pos.clone().requires_grad_(need_pos),
                                 res).sum().backward()
        dts.append(tt.grad)
    assert _rel_err(dts[0], dts[1]) <= DTABLE_TOL


def test_hash_field_runs_in_both_compute_dtypes(cuda):
    """The encode is float32 throughout and takes no compute dtype: the
    field runs on the card in the bf16 and the float32 arm."""
    from cropnerf_tpu_torch.models.field import field_density
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    cfg = PRESETS["cropnerf-tiny"].model
    params = model_init(cfg, 2, torch.Generator().manual_seed(0), cuda)
    x = torch.randn((4096, 3), device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        before = khash.hash_encode.launches
        with torch.no_grad():
            density, geo = field_density(params.field, x, cfg.field,
                                         compute_dtype=dtype)
        assert khash.hash_encode.launches == before + 1
        assert torch.isfinite(density).all() and torch.isfinite(geo).all()


def _plain_grid(cfg):
    """``cfg`` with every hash grid on the plain PyTorch encode."""
    def plain(g):
        return dataclasses.replace(g, impl="plain")
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, grid=plain(m.field.grid)),
        proposal_fields=tuple(dataclasses.replace(p, grid=plain(p.grid))
                              for p in m.proposal_fields)))


@pytest.mark.parametrize("step", [300, 5001], ids=["update", "no-update"])
def test_cropnerf_train_step_kernel_path_matches_plain_path(cuda, step):
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import train_loss
    cfg = dataclasses.replace(PRESETS["cropnerf"],
                              train_num_rays_per_batch=1024)
    bank = _synthetic_bank(cuda)
    results = []
    for c in (cfg, _plain_grid(cfg)):
        state = create_train_state(c, bank.num_images,
                                   torch.Generator().manual_seed(0), cuda)
        gen = torch.Generator(device=cuda).manual_seed(1)
        idx = torch.randint(0, bank.num_pixels, (1024,), generator=gen,
                            device=cuda)
        before = (khash.hash_encode.launches, khash.hash_encode_bwd.launches)
        loss, _ = train_loss(state.params, bank, idx, step, c, gen)
        loss.backward()
        launched = (khash.hash_encode.launches - before[0],
                    khash.hash_encode_bwd.launches - before[1])
        assert launched == (((3, 3) if step == 300 else (3, 1))
                            if c is cfg else (0, 0)), launched
        results.append((loss.detach(), {
            k: p.grad.clone() for k, p in state.params.named_parameters()
            if p.grad is not None}))
    (l_k, g_k), (l_p, g_p) = results
    assert torch.isfinite(l_k) and abs(l_k - l_p) <= 1e-3 * abs(l_p)
    assert set(g_k) == set(g_p)
    assert any(k.startswith("proposal_") for k in g_k) == (step == 300)
    for k in g_p:
        assert torch.isfinite(g_k[k]).all(), k
        assert _rel_err(g_k[k], g_p[k]) <= BWD_TOL, (k, _rel_err(g_k[k], g_p[k]))
