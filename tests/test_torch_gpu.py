"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; every test skips where no CUDA device is visible (decided in
a fixture).  The machine with the card has no JAX, so run this file without
the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance of the MLP kernels (K1-K3 and K5; K4, the float32 hash-grid
encode, and K6, the transmittance scan, state their own above their
tests): the kernel and the plain version round the same operands to bf16
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


# Row counts at the edges of the forward's persistent tiling: one row,
# either side of a 64-row warpgroup block, one tile past a block's first,
# either side of one 128-row tile per SM, and a ragged training batch.
FWD_EDGE_N = [1, 64, 65, 129, 128 * 132 - 1, 128 * 132 + 1, 196_608 - 77]


@pytest.mark.parametrize("hidden", [256, 64])
@pytest.mark.parametrize("n", FWD_EDGE_N)
@torch.no_grad()
def test_fused_pe_nerf_forward_tiling_edges(cuda, n, hidden):
    """K1's forward at the tiling's edges against its plain version; each
    call counts one launch, and two runs give the same bits."""
    cfg, params = _field(cuda, hidden_dim=hidden)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    x, extras = _field_inputs(n, color[1].shape[0], cuda, seed=11)
    before = kfield.fused_pe_nerf.launches
    got = kfield.fused_pe_nerf(x, extras, base, top, color, sem, POS_FREQS)
    again = kfield.fused_pe_nerf(x, extras, base, top, color, sem, POS_FREQS)
    torch.cuda.synchronize()
    assert kfield.fused_pe_nerf.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the forward kernel is not deterministic"
    ref = kfield.fused_pe_nerf_plain(x, extras, base, top, color, sem,
                                     POS_FREQS)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        assert _rel_err(g, r) <= TOL, (name, _rel_err(g, r))


@pytest.mark.parametrize("hidden", [256, 64])
@pytest.mark.parametrize("n", FWD_EDGE_N)
@torch.no_grad()
def test_fused_pe_density_forward_tiling_edges(cuda, n, hidden):
    """K2's forward (the trunk-only program) at the tiling's edges."""
    cfg, params = _field(cuda, hidden_dim=hidden)
    base, top, _, _ = fused_field_weights(params.field, cfg.field)
    x, _ = _field_inputs(n, 1, cuda, seed=12)
    before = kfield.fused_pe_density.launches
    got = kfield.fused_pe_density(x, base, top, POS_FREQS)
    again = kfield.fused_pe_density(x, base, top, POS_FREQS)
    torch.cuda.synchronize()
    assert kfield.fused_pe_density.launches == before + 2
    assert torch.equal(got, again), "the forward kernel is not deterministic"
    ref = kfield.fused_pe_density_plain(x, base, top, POS_FREQS)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL, _rel_err(got, ref)


# K3 (fused_mlp): the heads of cropnerf-mxu and -q, a three-layer net, a
# 128-wide net and -big's and -huge's heads (128 and 256 wide) on the wgmma
# kernels; a 3-layer net 256 wide, too large for their shared memory,
# -huge's semantic head at 256 wide and a 6-layer net on the stream route
K3_DIMS = [(15, 64, 1), (74, 64, 3), (39, 64, 48, 16), (15, 128, 1),
           (63, 256, 256, 16), (30, 128, 128, 1), (185, 128, 3), (89, 256, 3),
           (30, 256, 256, 1), (39, 128, 128, 128, 128, 128, 7)]
K3_IDS = ["semantic-head", "colour-head", "three-layers", "128-wide", "wide",
          "big-semantic-head", "big-colour-head", "huge-colour-head",
          "huge-semantic-256", "six-layers"]
K3_STREAM = [(63, 256, 256, 16), (30, 256, 256, 1),
             (39, 128, 128, 128, 128, 128, 7)]
# the nets the BayesRays batches of -big (4096 rays x 128 samples) and
# -huge (4096 x 64) send through the backward
K3_BAYESRAYS = [((30, 128, 128, 1), 524_288), ((185, 128, 3), 524_288),
                ((30, 128, 128, 1), 262_144), ((89, 256, 3), 262_144)]


def _k3_net(cuda, dims, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    wbs = []
    for i in range(len(dims) - 1):
        wbs.append(torch.randn((dims[i], dims[i + 1]), generator=g,
                               device=cuda) / dims[i] ** 0.5)
        wbs.append(torch.randn((1, dims[i + 1]), generator=g, device=cuda)
                   * 0.05)
    return g, wbs


def _k3_counters(route, backward=False):
    """The launch counter of K3's route, forward or backward."""
    if backward:
        return (kmlp.fused_mlp_bwd if route == "wgmma"
                else kmlp.fused_mlp_stream_bwd)
    return kmlp.fused_mlp if route == "wgmma" else kmlp.fused_mlp_stream


def _k3_launches():
    return [k.launches for k in (kmlp.fused_mlp, kmlp.fused_mlp_stream,
                                 kmlp.fused_mlp_bwd, kmlp.fused_mlp_stream_bwd)]


@pytest.mark.parametrize("dims", K3_DIMS, ids=K3_IDS)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 65_536 - 3])
@torch.no_grad()
def test_fused_mlp_kernel_matches_plain(cuda, dims, n):
    """K3's forward on the route the net's shape picks, each route counting
    its own launches, against the plain version, at the tiles' edges and an
    export chunk's ragged N; two runs give the same bits."""
    g, wbs = _k3_net(cuda, dims)
    route = kmlp.fused_mlp_route(dims[0], dims[1:])
    assert route == ("stream" if dims in K3_STREAM else "wgmma")
    x = torch.randn((n, dims[0]), generator=g, device=cuda)
    before = _k3_launches()
    got = kmlp.fused_mlp(x, wbs)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_k3_launches(), before)]
    assert moved == ([1, 0, 0, 0] if route == "wgmma" else [0, 1, 0, 0])
    ref = kmlp.fused_mlp_plain(x, wbs)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL
    assert torch.equal(got, kmlp.fused_mlp(x, wbs)), "not deterministic"


@pytest.mark.parametrize("dims", K3_DIMS[:3] + K3_DIMS[5:],
                         ids=K3_IDS[:3] + K3_IDS[5:])
@pytest.mark.parametrize("n", [64, 1000, 65_536 - 3])
@torch.no_grad()
def test_fused_mlp_on_an_unaligned_x(cuda, dims, n):
    """x a contiguous view one row into a larger tensor, so its address is
    not 16-byte aligned for these widths: the wgmma kernels load it with
    ordinary loads, and every route gives the same bits as on an aligned
    copy."""
    g, wbs = _k3_net(cuda, dims)
    big = torch.randn((n + 1, dims[0]), generator=g, device=cuda)
    x = big[1:]
    assert x.is_contiguous() and x.data_ptr() % 16
    got = kmlp.fused_mlp(x, wbs)
    assert torch.equal(got, kmlp.fused_mlp(x.clone(), wbs))
    assert _rel_err(got, kmlp.fused_mlp_plain(x, wbs)) <= TOL


def test_kernels_refuse_float32_and_autograd(cuda):
    """float32 compute runs only on the CPU; every MLP kernel now has its
    backward, so K1, K2 and K3 all record a graph."""
    cfg, params = _field(cuda)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    x, extras = _field_inputs(256, color[1].shape[0], cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        kfield.fused_pe_density(x, base, top, POS_FREQS, torch.float32)
    heads = [params.field.mlp_semantic.w[0], params.field.mlp_semantic.b[0]
             .reshape(1, -1), params.field.mlp_semantic.w[1],
             params.field.mlp_semantic.b[1].reshape(1, -1)]
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        kmlp.fused_mlp(x[:, :1].expand(256, 15).contiguous(), heads,
                       torch.float32)
    assert kfield.fused_pe_density(x, base, top, POS_FREQS).requires_grad
    assert kmlp.fused_mlp(x[:, :1].expand(256, 15).contiguous(),
                          heads).requires_grad
    t, _, _ = kfield.fused_pe_nerf(x, extras, base, top, color, sem,
                                   POS_FREQS)
    assert t.requires_grad


def _grads(outs, inputs, cots):
    return torch.autograd.grad(outs, inputs, cots)


def _grad_agrees(got, ref, per_row: bool, tol: float = BWD_TOL) -> bool:
    if not per_row:
        return _rel_err(got, ref) <= tol
    row_err = (got - ref).abs().amax(dim=1) / ref.abs().max()
    l2 = ((got - ref).norm() / ref.norm()).item()
    return (row_err <= tol).float().mean().item() >= ROW_SHARE and l2 <= tol


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


@pytest.mark.parametrize("preset", ["cropnerf-mxu-q", "cropnerf-mxu-big",
                                    "cropnerf-mxu-huge"])
def test_fused_pe_nerf_preset_widths(cuda, preset):
    """K1 forward and backward at the widths of the other fused-field
    presets against the plain version: ``-big``'s 155 extras columns are
    too wide for the forward's register prefetch and go straight to shared
    memory; ``-big`` and ``-huge`` have 31 trunk outputs and a 3-layer
    semantic head."""
    cfg = PRESETS[preset].model
    params = model_init(cfg, 8, torch.Generator().manual_seed(0), cuda)
    base, top, color, sem = fused_field_weights(params.field, cfg.field)
    n = 65_536 - 45
    x, extras = _field_inputs(n, color[1].shape[0], cuda, seed=13)
    x.requires_grad_(True)
    extras.requires_grad_(True)
    wbs = [*base, *top, *color, *sem]
    before = (kfield.fused_pe_nerf.launches, kfield.fused_pe_nerf_bwd.launches)
    got = kfield.fused_pe_nerf(x, extras, base, top, color, sem, POS_FREQS)
    ref = kfield.fused_pe_nerf_plain(x, extras, base, top, color, sem,
                                     POS_FREQS)
    for name, a, b in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= TOL, (name, _rel_err(a, b))
    g = torch.Generator(device=cuda).manual_seed(5)
    cots = [torch.randn(o.shape, generator=g, device=cuda) for o in ref]
    got_g = _grads(got, [x, extras, *wbs], cots)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_nerf.launches,
            kfield.fused_pe_nerf_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_g = _grads(ref, [x, extras, *wbs], cots)
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _grad_agrees(a, b, per_row=i < 2), (i, _rel_err(a, b))


def _leaves(ws, need_dw):
    return [w.detach().clone().requires_grad_(need_dw) for w in ws]


def _weight_grad_agrees(got, ref, n: int, tol: float = BWD_TOL) -> bool:
    """Weight and bias gradients of the K2 and K3 backwards: within ``tol``
    (BWD_TOL) in relative L2 norm, and within ``tol`` of max |plain| over
    1000 rows or more.  A relu unit that takes the other side in one row
    moves that row's outer product, up to ~10 % of the largest entry when
    the sum runs over a single 128-row tile; more rows dilute it."""
    l2 = ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item()
    return l2 <= tol and (n < 1000 or _rel_err(got, ref) <= tol)


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("n", [128, 1000, 196_608 - 77, 196_608])
def test_fused_pe_density_backward_kernel_matches_plain(cuda, n, need_dw):
    """K2's backward (the trunk-only mode of csrc/fused_pe_field_bwd.cu),
    with the weight gradients and with dx alone (the BayesRays pass); dx
    alone is bit-identical to the dx of the full backward."""
    cfg, params = _field(cuda)
    base, top, _, _ = fused_field_weights(params.field, cfg.field)
    base, top = _leaves(base, need_dw), _leaves(top, need_dw)
    x, _ = _field_inputs(n, 1, cuda, seed=2)
    x.requires_grad_(True)
    leaves = [x] + (base + top if need_dw else [])
    cot = torch.randn((n, top[-2].shape[1]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(5))
    before = (kfield.fused_pe_density.launches,
              kfield.fused_pe_density_bwd.launches)
    got = _grads(kfield.fused_pe_density(x, base, top, POS_FREQS), leaves, cot)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_density.launches,
            kfield.fused_pe_density_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref = _grads(kfield.fused_pe_density_plain(x, base, top, POS_FREQS),
                 leaves, cot)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, per_row=True) if i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kfield.fused_pe_density(x, base, top, POS_FREQS), leaves,
                   cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"
    if not need_dw:
        full = _grads(kfield.fused_pe_density(x, _leaves(base, True),
                                              _leaves(top, True), POS_FREQS),
                      [x], cot)
        assert torch.equal(full[0], got[0])


# Row counts at the edges of the backward's tiling: empty, one row, either
# side of a 64-row warpgroup block and of a 128-row tile, and a ragged
# BayesRays-sized batch.
EDGE_N = [0, 1, 63, 64, 65, 127, 129, 196_531]


@pytest.mark.parametrize("pass_sem", [False, True])
@pytest.mark.parametrize("n", EDGE_N)
@torch.no_grad()
def test_fused_pe_nerf_backward_tiling_edges(cuda, n, pass_sem):
    """K1's backward at the tiling's edges against autograd through the
    plain version; two runs give the same bits."""
    cfg, params = _field(cuda)
    groups = [[w.detach() for w in grp]
              for grp in fused_field_weights(params.field, cfg.field)]
    x, extras = _field_inputs(n, groups[2][1].shape[0], cuda, seed=7)
    g = torch.Generator(device=cuda).manual_seed(8)
    cots = [torch.randn((n, c), generator=g, device=cuda) for c in (16, 3, 1)]
    got = kfield.fused_pe_nerf_bwd(x, extras, *groups, POS_FREQS, *cots,
                                   pass_sem)
    again = kfield.fused_pe_nerf_bwd(x, extras, *groups, POS_FREQS, *cots,
                                     pass_sem)
    flat = lambda out: [out[0], out[1]] + [t for grp in out[2:] for t in grp]  # noqa: E731
    got, again = flat(got), flat(again)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"
    leaves = [t.clone().requires_grad_(True)
              for t in (x, extras, *[w for grp in groups for w in grp])]
    nb, nt, nc = (len(grp) for grp in groups[:3])
    w = leaves[2:]
    with torch.enable_grad():
        outs = kfield.fused_pe_nerf_plain(
            leaves[0], leaves[1], w[:nb], w[nb:nb + nt],
            w[nb + nt:nb + nt + nc], w[nb + nt + nc:], POS_FREQS,
            pass_sem_grad=pass_sem)
        ref = list(torch.autograd.grad(outs, leaves, cots, allow_unused=True))
    for i, (a, b) in enumerate(zip(got, ref)):
        b = torch.zeros_like(a) if b is None else b
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        if n == 0:
            assert not a.abs().sum(), i
            continue
        ok = (_grad_agrees(a, b, per_row=True) if i < 2
              else _weight_grad_agrees(a, b, n))
        assert ok, (n, i, _rel_err(a, b))


@pytest.mark.parametrize("n", EDGE_N)
@torch.no_grad()
def test_fused_pe_density_backward_tiling_edges(cuda, n):
    """K2's backward at the tiling's edges: dx alone and the weight
    gradients alone are bit-equal to the full backward's, two runs give the
    same bits, and the full backward agrees with autograd through the plain
    version."""
    cfg, params = _field(cuda)
    base, top, _, _ = fused_field_weights(params.field, cfg.field)
    base, top = [w.detach() for w in base], [w.detach() for w in top]
    x, _ = _field_inputs(n, 1, cuda, seed=9)
    cot = torch.randn((n, top[-2].shape[1]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(10))
    bwd = lambda dx, dw: kfield.fused_pe_density_bwd(  # noqa: E731
        x, base, top, POS_FREQS, cot, dx, dw)
    dx, d_base, d_top = bwd(True, True)
    full = [dx, *d_base, *d_top]
    again = bwd(True, True)
    assert all(torch.equal(a, b) for a, b in
               zip(full, [again[0], *again[1], *again[2]]))
    dx_only = bwd(True, False)
    assert dx_only[1] is None and torch.equal(dx_only[0], dx)
    dw_only = bwd(False, True)
    assert dw_only[0] is None
    assert all(torch.equal(a, b) for a, b in
               zip(full[1:], [*dw_only[1], *dw_only[2]]))
    leaves = [t.clone().requires_grad_(True) for t in (x, *base, *top)]
    with torch.enable_grad():
        out = kfield.fused_pe_density_plain(
            leaves[0], leaves[1:len(base) + 1], leaves[len(base) + 1:],
            POS_FREQS)
        ref = torch.autograd.grad(out, leaves, cot)
    for i, (a, b) in enumerate(zip(full, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        if n == 0:
            assert not a.abs().sum(), i
            continue
        ok = (_grad_agrees(a, b, per_row=True) if i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (n, i, _rel_err(a, b))


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("n", [196_608, 196_608 - 3, 127, 1, 63, 64, 65])
@pytest.mark.parametrize("dims", K3_DIMS, ids=K3_IDS)
def test_fused_mlp_backward_kernel_matches_plain(cuda, dims, n, need_dw):
    """K3's backward on the vanilla field's heads (the BayesRays batch,
    ragged N and the tiles' edges), a three-layer net and the stream
    route's nets, each route counting its own launches; two runs give the
    same bits."""
    g, wbs = _k3_net(cuda, dims)
    route = kmlp.fused_mlp_route(dims[0], dims[1:])
    wbs = _leaves(wbs, need_dw)
    x = torch.randn((n, dims[0]), generator=g, device=cuda, requires_grad=True)
    cot = torch.randn((n, dims[-1]), generator=g, device=cuda)
    leaves = [x] + (wbs if need_dw else [])
    before = _k3_launches()
    got = _grads(kmlp.fused_mlp(x, wbs), leaves, cot)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_k3_launches(), before)]
    assert moved == ([1, 0, 1, 0] if route == "wgmma" else [0, 1, 0, 1])
    ref = _grads(kmlp.fused_mlp_plain(x, wbs), leaves, cot)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, per_row=True) if i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kmlp.fused_mlp(x, wbs), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"


@pytest.mark.parametrize("dims", K3_DIMS[:4] + K3_DIMS[5:],
                         ids=K3_IDS[:4] + K3_IDS[5:])
def test_fused_mlp_backward_asks_and_alignment(cuda, dims):
    """Each route's backward: dx alone and the weight gradients alone are
    the full backward's bits; on x and g one float into larger buffers
    (not 16-byte aligned) the same bits again."""
    g, wbs = _k3_net(cuda, dims)
    n = 4099
    xb = torch.randn((n * dims[0] + 1,), generator=g, device=cuda)
    gb = torch.randn((n * dims[-1] + 1,), generator=g, device=cuda)
    x_off, g_off = xb[1:].view(n, dims[0]), gb[1:].view(n, dims[-1])
    assert x_off.data_ptr() % 16 and g_off.data_ptr() % 16
    x, cot = x_off.clone(), g_off.clone()
    dx, dw = kmlp.fused_mlp_bwd(x, wbs, cot, True, True)
    dx_only, none = kmlp.fused_mlp_bwd(x, wbs, cot, True, False)
    no_dx, dw_only = kmlp.fused_mlp_bwd(x, wbs, cot, False, True)
    assert none is None and no_dx is None
    assert torch.equal(dx, dx_only)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_only))
    off_dx, off_dw = kmlp.fused_mlp_bwd(x_off, wbs, g_off, True, True)
    assert torch.equal(dx, off_dx)
    assert all(torch.equal(a, b) for a, b in zip(dw, off_dw))


@pytest.mark.parametrize("case", range(len(K3_BAYESRAYS)),
                         ids=["big-semantic", "big-colour", "huge-semantic",
                              "huge-colour"])
def test_fused_mlp_backward_at_the_bayesrays_batches(cuda, case):
    """K3's dx-only backward of -big's and -huge's heads at the BayesRays
    batch each preset makes, on the wgmma kernel (one launch), against
    autograd through the plain version, row by row; two runs give the
    same bits."""
    dims, n = K3_BAYESRAYS[case]
    g, wbs = _k3_net(cuda, dims)
    x = torch.randn((n, dims[0]), generator=g, device=cuda)
    cot = torch.randn((n, dims[-1]), generator=g, device=cuda)
    before = _k3_launches()
    dx, _ = kmlp.fused_mlp_bwd(x, wbs, cot, True, False)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_k3_launches(), before)] == [0, 0, 1, 0]
    leaf = x.clone().requires_grad_(True)
    ref, = _grads(kmlp.fused_mlp_plain(leaf, wbs), [leaf], cot)
    assert _grad_agrees(dx, ref, per_row=True), _rel_err(dx, ref)
    assert torch.equal(dx, kmlp.fused_mlp_bwd(x, wbs, cot, True, False)[0])


def test_fused_mlp_layouts_take_the_routed_nets(cuda):
    """Every net the route sends to the wgmma kernels has a layout in both
    kernels, with and without weight gradients, within a block's shared
    memory; the route's own estimate of the largest is the C layout's."""
    nets = [d for d in K3_DIMS if d not in K3_STREAM] + [
        (128, 64, 16), (129, 64, 1), (96, 256, 3), (205, 128, 3),
        (93, 128, 128, 1)]
    for dims in nets:
        din, widths = dims[0], list(dims[1:])
        assert kmlp.fused_mlp_route(din, widths) == "wgmma", dims
        hw = kmlp.mlp_hidden_pad(din, widths)
        fwd = kmlp.mlp_layout(din, widths[-1], len(widths), hw)
        assert 0 < fwd[2] <= 232_448 and fwd[3] >= 1, (dims, fwd)
        for need_dw in (False, True):
            bwd = kmlp.mlp_layout(din, widths[-1], len(widths), hw, need_dw)
            assert 0 < bwd[4] <= 232_448 and bwd[5] >= 1, (dims, bwd)
            if need_dw and bwd[5] == 1 and bwd[7] == 1:
                assert bwd[4] == kmlp._least_bwd_smem(
                    din, widths[-1], len(widths), hw), dims


def test_pe_mlp_wide_layouts_take_the_routed_nets(cuda):
    """Every PE net the K5 route sends to the wide kernels has a layout in
    the forward's PE variant and in the backward's, without weight
    gradients (csrc/fused_mlp_bwd.cu) and with them
    (csrc/fused_pe_mlp_wide_bwd.cu: one warpgroup taking tiles and one
    partial row a block), within a block's shared memory, at least the
    route's estimate (equal at one stage and one operand-tile set; -q's
    nets take two sets); a 3-layer net 256 wide has none (the stream
    route takes it)."""
    for F, widths in ((5, [128, 128, 1]), (6, [128, 128, 1]),
                      (10, [128, 128, 16]), (5, [256, 1]), (5, [64, 65, 1])):
        din = 3 * (1 + 2 * F)
        assert kfield.pe_mlp_fwd_route(3, F, widths) == "wide", widths
        hw = kmlp.mlp_hidden_pad(din, widths)
        fwd = kmlp.mlp_layout(din, widths[-1], len(widths), hw, pe=True)
        assert 0 < fwd[2] <= 232_448 and fwd[3] >= 1, (widths, fwd)
        for need_dw in (False, True):
            bwd = kmlp.mlp_layout(din, widths[-1], len(widths), hw, need_dw,
                                  True)
            assert 0 < bwd[4] <= 232_448 and bwd[5] >= 1, (widths, bwd)
            if need_dw:
                least = kmlp._least_bwd_smem(din, widths[-1], len(widths), hw,
                                             pe=True)
                assert bwd[5] == 1 and bwd[6] == 1 and least <= bwd[4], (
                    widths, bwd, least)
                if bwd[7] == 1 and bwd[8] == 1:
                    assert bwd[4] == least, widths
                if widths == [128, 128, 1]:
                    assert bwd[8] == 2, (widths, bwd)
    assert kfield.pe_mlp_fwd_route(3, 5, [256, 256, 1]) == "stream"
    with pytest.raises(ValueError):
        kmlp.mlp_layout(33, 1, 3, 256, True, True)


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


@pytest.mark.parametrize("case", list(HASH_CASES))
def test_hash_encode_forward_is_bit_identical(cuda, case):
    """K4's forward equals the plain version bit for bit at the path's
    shapes, a ragged N, a small dense [L, T, F] table and a hash-only
    table, with positions at exactly 0 and 1 and on grid vertices, at its
    level groups (the proposal nets' 5 levels one group, the field's 16
    four)."""
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    *shape, mode = HASH_CASES[case]
    table, pos, res, t = _hash_inputs(cuda, *shape, mode)
    table2d, offsets, dense, t = hashgrid._table_layout(table, res, mode, t)
    layout = (tuple(res), tuple(offsets), tuple(dense), t)
    before = khash.hash_encode.launches
    out = khash.hash_encode_fwd(table2d, pos, *layout)
    torch.cuda.synchronize()
    assert khash.hash_encode.launches == before + 1
    ref = hashgrid.hashgrid_encode_plain(table, pos, res, mode, t)
    assert out.shape == ref.shape and torch.equal(out, ref)
    empty = khash.hash_encode_fwd(table2d, pos[:0], *layout)
    assert empty.shape == (0, ref.shape[1])
    assert khash.hash_encode.launches == before + 1


@pytest.mark.parametrize("case", ["dense-layout", "proposal1"])
def test_hash_encode_forward_on_a_table_offset_by_a_row(cuda, case):
    """A table whose first row sits 8 bytes past a 16-byte boundary (a
    view one row into a larger tensor): the dense levels' paired 16-byte
    loads take their other path, and the forward keeps its bits."""
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    *shape, mode = HASH_CASES[case]
    table, pos, res, t = _hash_inputs(cuda, *shape, mode)
    table2d, offsets, dense, t = hashgrid._table_layout(table, res, mode, t)
    shifted = torch.cat([torch.zeros((1, 2), device=cuda), table2d])[1:]
    assert shifted.data_ptr() % 16 == 8 and torch.equal(shifted, table2d)
    out = khash.hash_encode_fwd(shifted, pos, tuple(res), tuple(offsets),
                                tuple(dense), t)
    ref = hashgrid.hashgrid_encode_plain(table, pos, res, mode, t)
    assert torch.equal(out, ref)


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


def test_hash_encode_backward_without_table_gradient(cuda):
    """A table that needs no gradient (the BayesRays pass) takes the
    dpos-only variant: no table gradient, the same position gradient."""
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    table, pos, res, t = _hash_inputs(cuda, *HASH_CASES["field-ragged"])
    dps = []
    for need_table in (False, True):
        tt = table.clone().requires_grad_(need_table)
        tp = pos.clone().requires_grad_(True)
        before = khash.hash_encode_bwd.launches
        hashgrid.hashgrid_encode(tt, tp, res, "auto", t).sum().backward()
        torch.cuda.synchronize()
        assert khash.hash_encode_bwd.launches == before + 1
        assert (tt.grad is not None) == need_table
        dps.append(tp.grad)
    assert torch.equal(dps[0], dps[1])


# K4's backward on positions that collide: (grid, N, kind).  Against the
# plain version with a float64 table (the positions and cells stay float32),
# so that the reference's own float32 sums do not set the error.
K4_BWD_CASES = {
    "one-coarse-cell": ("field", 65_536, "cell"),
    "identical": ("field", 65_536, "same"),
    "cell-edges": ("field", 65_536, "edges"),
    "rays": ("proposal0", 262_144, "rays"),
    "huge-layout": ("huge-field", 100_000, "uniform"),
    "dense-layout": ("dense", 5000, "edges"),
    "ragged": ("proposal1", 1003, "uniform"),
}
K4_GRIDS = {  # (layout, levels, log2 T, min res, max res) or a preset's field
    "field": ("packed", 16, 19, 16, 2048),
    "proposal0": ("packed", 5, 17, 16, 128),
    "proposal1": ("packed", 5, 17, 16, 256),
    "dense": ("dense", 4, 12, 4, 32),
}


def _k4_bwd_inputs(cuda, grid, n, kind):
    from cropnerf_tpu_torch.ops import hashgrid
    if grid == "huge-field":
        gc = PRESETS["cropnerf-huge"].model.field.grid
        layout, levels, log2_t = "packed", gc.num_levels, gc.log2_hashmap_size
        lo, hi = gc.min_res, gc.max_res
    else:
        layout, levels, log2_t, lo, hi = K4_GRIDS[grid]
    table, pos, res, t = _hash_inputs(cuda, layout, n, levels, log2_t, lo, hi,
                                      "auto", seed=12)
    g = torch.Generator(device=cuda).manual_seed(13)
    if kind == "cell":                        # one cell of level 0 (r = 16)
        pos = 0.26 + torch.rand((n, 3), generator=g, device=cuda) * 0.05
    elif kind == "same":
        pos = torch.full((n, 3), 0.4, device=cuda)
    elif kind == "edges":                     # vertices k/r of every level, 1.0
        r = torch.tensor(res, device=cuda)[torch.randint(
            0, len(res), (n, 1), generator=g, device=cuda)].float()
        k = torch.floor(torch.rand((n, 3), generator=g, device=cuda) * (r + 1))
        pos = torch.minimum(k / r, torch.ones((), device=cuda))
        pos[:n // 8] = 1.0
    elif kind == "rays":                      # 256 samples along each ray
        start = torch.rand((n // 256, 1, 3), generator=g, device=cuda)
        d = torch.randn((n // 256, 1, 3), generator=g, device=cuda)
        step = torch.linspace(0, 0.5, 256, device=cuda)[None, :, None]
        pos = (start + d / d.norm(dim=-1, keepdim=True) * step).clamp(0, 1)
        pos = pos.reshape(-1, 3)
    return table, pos.contiguous(), res, t


@pytest.mark.parametrize("variant", ["both", "table", "dpos"])
@pytest.mark.parametrize("case", list(K4_BWD_CASES))
def test_hash_encode_backward_on_colliding_positions(cuda, case, variant):
    """Each variant of K4's backward (the training step's, the table
    alone, the BayesRays pass's dpos alone) where many contributions land
    on one row: the table gradient within DTABLE_TOL and dpos within
    DPOS_TOL of the float64 reference; dpos the same bits in every variant;
    one launch."""
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    table, pos, res, t = _k4_bwd_inputs(cuda, *K4_BWD_CASES[case])
    cot = torch.randn((pos.shape[0], 2 * len(res)), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(14))
    table2d, offsets, dense, t = hashgrid._table_layout(table, res, "auto", t)
    layout = (tuple(res), tuple(offsets), tuple(dense), t)
    need_t, need_p = variant in ("both", "table"), variant in ("both", "dpos")
    before = khash.hash_encode_bwd.launches
    dt, dp = khash.hash_encode_bwd(table2d, pos, cot, *layout,
                                   need_dpos=need_p, need_dtable=need_t)
    torch.cuda.synchronize()
    assert khash.hash_encode_bwd.launches == before + 1
    assert (dt is not None, dp is not None) == (need_t, need_p)
    tt = table.double().requires_grad_(True)
    tp = pos.clone().requires_grad_(True)
    hashgrid.hashgrid_encode_plain(tt, tp, res, table_size=t).backward(
        cot.double())
    if need_t:
        ref = tt.grad.reshape(-1, 2)
        assert torch.isfinite(dt).all()
        assert _rel_err(dt.double(), ref) <= DTABLE_TOL, _rel_err(dt.double(), ref)
    if need_p:
        assert _rel_err(dp.double(), tp.grad.double()) <= DPOS_TOL
        _, dp_both = khash.hash_encode_bwd(table2d, pos, cot, *layout)
        assert torch.equal(dp, dp_both)


def test_hash_encode_backward_of_no_positions(cuda):
    """N = 0: a zero table gradient, an empty dpos, no launch."""
    from cropnerf_tpu_torch.ops import hashgrid
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    table, pos, res, t = _hash_inputs(cuda, *HASH_CASES["field"][:-1], "auto")
    table2d, offsets, dense, t = hashgrid._table_layout(table, res, "auto", t)
    before = khash.hash_encode_bwd.launches
    dt, dp = khash.hash_encode_bwd(
        table2d, pos[:0].contiguous(), torch.zeros((0, 2 * len(res)),
                                                   device=cuda),
        tuple(res), tuple(offsets), tuple(dense), t)
    assert khash.hash_encode_bwd.launches == before
    assert dp.shape == (0, 3) and dt.shape == table2d.shape
    assert not dt.any()


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


# ---- BayesRays: the kernel path against the plain path ----------------------
#
# The Hessian grid is a sum of squared position gradients.  The hash model
# is float32 around its MLPs' bf16 products on both paths, so its grid
# agrees to 1e-3 in relative L2; the PE trunk's dx differs row by row where
# a relu unit flips (above), so its grid is held to 5e-2 in relative L2 and
# by its 1,000 hottest cells (90 % shared).

def _uncertainty_bundle(cuda, n=512):
    from cropnerf_tpu_torch.core.cameras import near_far_collider
    from cropnerf_tpu_torch.core.rays import RayBundle
    g = torch.Generator(device=cuda).manual_seed(8)
    d = torch.randn((n, 3), generator=g, device=cuda)
    rb = RayBundle(origins=torch.tensor([[0.0, 0.0, 1.5]], device=cuda)
                   .expand(n, 3).contiguous(),
                   directions=d / d.norm(dim=-1, keepdim=True),
                   nears=torch.zeros((n,), device=cuda),
                   fars=torch.ones((n,), device=cuda),
                   camera_idx=torch.zeros((n,), dtype=torch.long, device=cuda))
    return near_far_collider(rb, 0.05, 1000.0)


@pytest.mark.parametrize("channel", ["semantics", "rgb"])
@pytest.mark.parametrize("preset", ["cropnerf-mxu", "cropnerf"])
def test_uncertainty_kernel_path_matches_plain_path(cuda, preset, channel):
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    from cropnerf_tpu_torch.uncertainty.bayesrays import ComputeUncertainty
    cfg = PRESETS[preset].model
    if preset == "cropnerf":
        plain = _plain_grid(PRESETS[preset]).model
    else:
        plain = dataclasses.replace(cfg, field=dataclasses.replace(
            cfg.field, mlp_impl="xla"))
    params = model_init(cfg, 8, torch.Generator().manual_seed(0), cuda)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("grid"):
                p.uniform_(-0.5, 0.5)
    rb = _uncertainty_bundle(cuda)
    kernels = (kfield.fused_pe_nerf, kfield.fused_pe_density,
               kfield.fused_pe_density_bwd, kmlp.fused_mlp,
               kmlp.fused_mlp_bwd, khash.hash_encode, khash.hash_encode_bwd)
    grids = []
    for c in (cfg, plain):
        before = [k.launches for k in kernels]
        grids.append(ComputeUncertainty(params, c, lod=6,
                                        channel=channel).batch(rb))
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        vjps = 1 if channel == "semantics" else 3
        want = ([0] * 7 if c is plain else
                [0, 0, 0, 0, 0, 3, vjps] if preset == "cropnerf" else
                [0, 1, vjps, 1, vjps, 0, 0])
        assert launched == want, (preset, c is plain, launched)
    got, ref = grids
    assert torch.isfinite(got).all() and got.max() > 0
    l2 = ((got - ref).norm() / ref.norm()).item()
    assert l2 <= (1e-3 if preset == "cropnerf" else 5e-2), l2
    hot = set(got.topk(1000).indices.tolist())
    assert len(hot & set(ref.topk(1000).indices.tolist())) >= 900
    assert all(p.requires_grad for p in params.parameters())


# ---- K5, the fused PE proposal nets (csrc/fused_pe_mlp_fwd.cu, forward, and
# csrc/fused_pe_mlp_bwd.cu, backward; for nets wider than 64 the PE variants
# of csrc/fused_mlp_fwd.cu and csrc/fused_mlp_bwd.cu, and for nets no wgmma
# kernel takes the PE variant of csrc/fused_mlp.cu's forward) ----------------
#
# Held as K3: outputs to TOL of max |plain|, dx row by row, weight and bias
# gradients in relative L2 (and by their max from 1000 rows on).

# (num_freqs, N): the two nets at one cropnerf-mxu training step's sample
# counts (4096 rays x 256 and x 96), a ragged N of each and a small N
K5_GPU_CASES = {"net0": (5, 1_048_576), "net1": (6, 393_216),
                "net0-ragged": (5, 1_048_576 - 77), "net1-ragged": (6, 1000)}


def _prop_net(cuda, num_freqs, need_dw=True, seed=0, hidden=64, layers=3):
    from cropnerf_tpu_torch.models.config import ProposalFieldConfig
    from cropnerf_tpu_torch.models.proposal import proposal_init
    cfg = ProposalFieldConfig(field_type="pe", hidden_dim=hidden,
                              num_layers=layers, pe_freqs=num_freqs,
                              mlp_impl="pallas-fused")
    prop = proposal_init(cfg, torch.Generator().manual_seed(seed), cuda)
    wbs = []
    for w, b in zip(prop.mlp.w, prop.mlp.b):
        wbs += [w, b.reshape(1, -1)]
    return _leaves(wbs, need_dw)


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("case", list(K5_GPU_CASES))
def test_fused_pe_mlp_kernel_matches_plain(cuda, case, need_dw):
    F, n = K5_GPU_CASES[case]
    wbs = _prop_net(cuda, F, need_dw)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.rand((n, 3), generator=g, device=cuda) * 2 - 1).requires_grad_(True)
    cot = torch.randn((n, 1), generator=g, device=cuda)
    leaves = [x] + (wbs if need_dw else [])
    before = (kfield.fused_pe_mlp.launches, kfield.fused_pe_mlp_bwd.launches)
    out = kfield.fused_pe_mlp(x, wbs, F)
    got = _grads(out, leaves, cot)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_mlp.launches, kfield.fused_pe_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_out = kfield.fused_pe_mlp_plain(x, wbs, F)
    ref = _grads(ref_out, leaves, cot)
    assert out.shape == (n, 1) and torch.isfinite(out).all()
    assert _rel_err(out.detach(), ref_out.detach()) <= TOL
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, per_row=True) if i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (i, _rel_err(a, b))
    out2 = kfield.fused_pe_mlp(x, wbs, F)
    again = _grads(out2, leaves, cot)
    assert torch.equal(out, out2), "the forward kernel is not deterministic"
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"


# (num_freqs, hidden width, layers, N, route) of the forward alone: both
# nets at a training step's sample counts, a ragged N, N < 64, one row and
# none, a two-layer net, cropnerf-mxu-q's 128-wide nets (the wide route), a
# two-layer net 256 wide, and on the stream route a 4-layer net and [prop256]'s
# nets (3 layers 256 wide) at a training step's sample counts
K5_FWD_GPU_CASES = {"net0": (5, 64, 3, 1_048_576, "wgmma"),
                    "net1": (6, 64, 3, 393_216, "wgmma"),
                    "net0-ragged": (5, 64, 3, 1_048_576 - 77, "wgmma"),
                    "net1-small": (6, 64, 3, 50, "wgmma"),
                    "one-row": (5, 64, 3, 1, "wgmma"),
                    "empty": (5, 64, 3, 0, "wgmma"),
                    "two-layers": (8, 32, 2, 4099, "wgmma"),
                    "q-net0": (5, 128, 3, 1_048_576, "wide"),
                    "q-net1-ragged": (6, 128, 3, 393_216 - 77, "wide"),
                    "q-small": (5, 128, 3, 50, "wide"),
                    "q-one-row": (6, 128, 3, 1, "wide"),
                    "q-empty": (5, 128, 3, 0, "wide"),
                    "two-layers-256": (5, 256, 2, 65_536 + 3, "wide"),
                    "four-layers": (5, 64, 4, 65_536 + 3, "stream"),
                    "prop256-net0": (5, 256, 3, 1_048_576, "stream"),
                    "prop256-net1-ragged": (6, 256, 3, 393_216 - 77, "stream"),
                    "prop256-one-row": (5, 256, 3, 1, "stream"),
                    "w512-net0": (5, 512, 3, 1_048_576, "stream"),
                    "w512-net1-ragged": (6, 512, 3, 393_216 - 77, "stream"),
                    "w512-three-tiles": (5, 512, 3, 300, "stream"),
                    "w512-one-row": (6, 512, 3, 1, "stream"),
                    "prop256-empty": (6, 256, 3, 0, "stream")}


@pytest.mark.parametrize("case", list(K5_FWD_GPU_CASES))
@torch.no_grad()
def test_fused_pe_mlp_forward_routes(cuda, case):
    """K5's forward on the route its net's shape picks: the wgmma kernel
    (csrc/fused_pe_mlp_fwd.cu) for nets up to 64 wide and the PE variant of
    csrc/fused_mlp_fwd.cu for the wider ones, both counted on
    fused_pe_mlp, and the stream route (csrc/fused_mlp_stream.cu) on
    fused_pe_mlp_stream; against the plain version, and the same bits on
    two runs."""
    F, hidden, layers, n, want = K5_FWD_GPU_CASES[case]
    wbs = _prop_net(cuda, F, False, hidden=hidden, layers=layers)
    widths = [w.shape[1] for w in wbs[0::2]]
    route = kfield.pe_mlp_fwd_route(3, F, widths)
    assert route == want
    g = torch.Generator(device=cuda).manual_seed(19)
    x = torch.rand((n, 3), generator=g, device=cuda) * 2 - 1
    before = (kfield.fused_pe_mlp.launches,
              kfield.fused_pe_mlp_stream.launches)
    out = kfield.fused_pe_mlp(x, wbs, F)
    torch.cuda.synchronize()
    launched = (kfield.fused_pe_mlp.launches - before[0],
                kfield.fused_pe_mlp_stream.launches - before[1])
    assert launched == ((0, 0) if n == 0 else (0, 1) if route == "stream"
                        else (1, 0))
    assert out.shape == (n, 1) and torch.isfinite(out).all()
    if n:
        assert _rel_err(out, kfield.fused_pe_mlp_plain(x, wbs, F)) <= TOL
        assert torch.equal(out, kfield.fused_pe_mlp(x, wbs, F))


@pytest.mark.parametrize("F", [5, 6])
def test_fused_pe_mlp_forward_same_bits_with_and_without_a_graph(cuda, F):
    """The wgmma forward on the forward half of the weight images (no graph
    recorded) and on the whole image (a graph recorded, the images saved
    for the backward) gives the same bits, a ragged last tile included."""
    wbs = _prop_net(cuda, F, True)
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.rand((4099, 3), generator=g, device=cuda) * 2 - 1
    with torch.no_grad():
        alone = kfield.fused_pe_mlp(x, wbs, F)
    recorded = kfield.fused_pe_mlp(x, wbs, F)
    assert recorded.requires_grad and not alone.requires_grad
    assert torch.equal(alone, recorded.detach())


def test_fused_pe_mlp_backward_computes_what_is_asked(cuda):
    """dx only where x needs it, weight gradients only where the weights
    need them; each alone equals the full backward's bit for bit.  N = 0
    launches nothing."""
    F, n = 5, 65_536 - 5
    x = torch.rand((n, 3), device=cuda) * 2 - 1
    cot = torch.randn((n, 1), device=cuda)
    full_w = _prop_net(cuda, F)
    xg = x.clone().requires_grad_(True)
    full = _grads(kfield.fused_pe_mlp(xg, full_w, F), [xg, *full_w], cot)
    dx_only = _grads(kfield.fused_pe_mlp(xg, _prop_net(cuda, F, False), F),
                     [xg], cot)
    w_only = _prop_net(cuda, F)
    dw_only = _grads(kfield.fused_pe_mlp(x, w_only, F), w_only, cot)
    assert torch.equal(dx_only[0], full[0])
    assert all(torch.equal(a, b) for a, b in zip(dw_only, full[1:]))
    before = (kfield.fused_pe_mlp.launches, kfield.fused_pe_mlp_bwd.launches)
    empty = x[:0].clone().requires_grad_(True)
    out = kfield.fused_pe_mlp(empty, full_w, F)
    grads = _grads(out, [empty, *full_w], torch.zeros((0, 1), device=cuda))
    assert out.shape == (0, 1) and grads[0].shape == (0, 3)
    assert all(float(g.abs().sum()) == 0 for g in grads[1:])
    assert (kfield.fused_pe_mlp.launches,
            kfield.fused_pe_mlp_bwd.launches) == before
    with torch.no_grad(), pytest.raises(ValueError, match="bf16"):
        kfield.fused_pe_mlp(x, full_w, F, torch.float32)


@pytest.mark.parametrize("n", [1, 63, 64 * 1000 + 5])
@pytest.mark.parametrize("F", [5, 6])
def test_fused_pe_mlp_backward_tiling_edges(cuda, F, n):
    """K5's backward at the edges of its 64-row tiles and of the persistent
    warpgroups' runs: dx and dW against the plain version, dx alone and dW
    alone the full backward's bits, two runs the same bits."""
    wbs = _prop_net(cuda, F)
    g = torch.Generator(device=cuda).manual_seed(15)
    x = (torch.rand((n, 3), generator=g, device=cuda) * 2 - 1).contiguous()
    cot = torch.randn((n, 1), generator=g, device=cuda)
    wd = [w.detach() for w in wbs]
    dx, dw = kfield.fused_pe_mlp_bwd(x, wd, F, cot, True, True)
    dx2, dw2 = kfield.fused_pe_mlp_bwd(x, wd, F, cot, True, True)
    dx_only, none = kfield.fused_pe_mlp_bwd(x, wd, F, cot, True, False)
    none2, dw_only = kfield.fused_pe_mlp_bwd(x, wd, F, cot, False, True)
    torch.cuda.synchronize()
    assert none is None and none2 is None
    assert torch.equal(dx, dx2) and all(torch.equal(a, b)
                                        for a, b in zip(dw, dw2))
    assert torch.equal(dx, dx_only) and all(torch.equal(a, b)
                                            for a, b in zip(dw, dw_only))
    leaves = [x.clone().requires_grad_(True)] + _leaves(wd, True)
    ref = _grads(kfield.fused_pe_mlp_plain(leaves[0], leaves[1:], F), leaves,
                 cot)
    assert dx.shape == (n, 3) and torch.isfinite(dx).all()
    assert _grad_agrees(dx, ref[0], per_row=True)
    for i, (a, b) in enumerate(zip(dw, ref[1:])):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _weight_grad_agrees(a, b, n), (i, _rel_err(a, b))


# (num_freqs, x's columns, output widths, N) of the stream route's
# backward: [prop256]'s nets at a training step's sample counts, a ragged
# N, one row, and the other nets of the route table (tests/
# test_torch_propfused.py ROUTE_EDGES): 69 encoding columns, 4 layers, 17
# outputs, x [N, 2], and at 256 encoding columns (x [N, 4], F = 30)
K5_STREAM_GPU_CASES = {"prop256-net0": (5, 3, [256, 256, 1], 1_048_576),
                       "prop256-net1": (6, 3, [256, 256, 1], 393_216),
                       "prop256-ragged": (5, 3, [256, 256, 1], 65_536 - 77),
                       "prop256-one-row": (6, 3, [256, 256, 1], 1),
                       "69-columns": (11, 3, [64, 64, 1], 65_536 + 3),
                       "69-columns-128": (11, 3, [128, 128, 1], 4099),
                       "four-layers": (5, 3, [64, 64, 64, 1], 65_536 + 3),
                       "four-layers-128": (5, 3, [128, 128, 128, 1], 4099),
                       "17-outputs": (5, 3, [64, 64, 17], 4099),
                       "x2": (5, 2, [64, 64, 1], 4099),
                       "x2-128": (5, 2, [128, 128, 1], 4099),
                       "244-columns": (30, 4, [256, 256, 1], 4099),
                       "w512-net0": (5, 3, [512, 512, 1], 1_048_576),
                       "w512-net1": (6, 3, [512, 512, 1], 393_216),
                       "w512-ragged": (5, 3, [512, 512, 1], 65_536 - 77),
                       "w512-one-row": (6, 3, [512, 512, 1], 1),
                       "prop256-three-tiles": (5, 3, [256, 256, 1], 300),
                       "w512-three-tiles": (5, 3, [512, 512, 1], 300)}


@pytest.mark.parametrize("case", list(K5_STREAM_GPU_CASES))
def test_fused_pe_mlp_stream_backward_matches_plain(cuda, case):
    """K5's backward on the stream route (csrc/fused_mlp_stream.cu), which
    records a graph for every net the route takes: through autograd (one
    launch each way, counted on fused_pe_mlp_stream and
    fused_pe_mlp_stream_bwd) against autograd of the plain version, dx row
    by row and the weight gradients in relative L2; dx alone and the
    weight gradients alone are the full backward's bits, and two runs give
    the same bits."""
    F, dim, widths, n = K5_STREAM_GPU_CASES[case]
    assert kfield.pe_mlp_fwd_route(dim, F, widths) == "stream"
    g = torch.Generator(device=cuda).manual_seed(29)
    dims = [dim * (1 + 2 * F), *widths]
    wbs = []
    for a, b in zip(dims[:-1], dims[1:]):
        wbs += [torch.randn((a, b), generator=g, device=cuda) / a ** 0.5,
                torch.randn((1, b), generator=g, device=cuda) * 0.05]
    x = (torch.rand((n, dim), generator=g, device=cuda) * 2 - 1)
    cot = torch.randn((n, widths[-1]), generator=g, device=cuda)
    leaves = [x.clone().requires_grad_(True)] + _leaves(wbs, True)
    before = (kfield.fused_pe_mlp_stream.launches,
              kfield.fused_pe_mlp_stream_bwd.launches)
    got = _grads(kfield.fused_pe_mlp(leaves[0], leaves[1:], F), leaves, cot)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_mlp_stream.launches - before[0],
            kfield.fused_pe_mlp_stream_bwd.launches - before[1]) == (1, 1)
    ref = _grads(kfield.fused_pe_mlp_plain(leaves[0], leaves[1:], F), leaves,
                 cot)
    assert got[0].shape == (n, dim) and torch.isfinite(got[0]).all()
    assert _grad_agrees(got[0], ref[0], per_row=True), _rel_err(got[0], ref[0])
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _weight_grad_agrees(a, b, n), (i, _rel_err(a, b))
    dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, True, True)
    dx_only, none = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, True, False)
    none2, dw_only = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, False, True)
    assert none is None and none2 is None
    assert torch.equal(dx, got[0]) and torch.equal(dx_only, dx)
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(dw, dw_only, got[1:]))


def test_stream_layouts_are_the_planned_ones(cuda):
    """The stream kernels' C layout functions give the shared memory that
    mlp_plan.stream_smem computes from the program, which the route's
    scope rests on, at the route's widest, deepest and narrowest nets (512
    wide: the wide programs' layouts)."""
    from cropnerf_tpu_torch.ops.cuda import mlp_plan
    nets = [(256, [256] * 32, 0, 0), (244, [256] * 32, 4, 30),
            (244, [256, 256, 1], 4, 30), (33, [256, 256, 1], 3, 5),
            (89, [256, 256, 3], 0, 0), (15, [1], 0, 0), (3, [16, 1], 3, 0),
            (512, [512] * 32, 0, 0), (244, [512] * 32, 4, 30),
            (33, [512, 512, 1], 3, 5), (15, [512, 1], 0, 0),
            (512, [16, 1], 0, 0)]
    # and every stream net of the backward's route table
    nets += [(dim * (1 + 2 * F), widths, dim, F)
             for F, dim, widths, _ in K5_STREAM_GPU_CASES.values()]
    for din, widths, dim, F in nets:
        for backward in (False, True):
            for need_dx, need_dw in ((True, True), (True, False),
                                     (False, True)):
                key = mlp_plan.program_key(din, widths, dim, F, backward,
                                           need_dx, need_dw)
                want = mlp_plan.stream_smem(mlp_plan.stream_plan(key).header,
                                            backward)[0]
                got = kmlp.stream_smem_bytes(key, backward)
                assert got == want and 0 < got <= 232_448, (din, widths, got)


def test_backward_tile_kernels_run_as_clusters(cuda):
    """The stream route's backward tile kernel, at every net of its route
    table, and K1's and K2's at [w512]'s widths run as persistent clusters
    (csrc/pe_tile.cuh cluster_launch): clusters of CLUSTER blocks (2, its
    mirror pe_plan.CLUSTER), at least one resident, the grid pe_plan.cluster_blocks sizes, no
    more blocks than SMs; K1 and K2 up to 256 wide keep one block a tile.
    The C layout of K1's and K2's tile kernel is pe_plan.bwd_tile_smem's."""
    from cropnerf_tpu_torch.ops.cuda import mlp_plan
    from cropnerf_tpu_torch.ops.cuda import pe_plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sizes = set()

    def held(grid, n, wide=True):
        tiles = -(-n // 128)
        if not wide:
            assert grid == dict(cluster=0, active_clusters=0, blocks=tiles,
                                error=0), grid
            return
        c, k = grid["cluster"], grid["active_clusters"]
        assert grid["error"] == 0 and c == pe_plan.CLUSTER and k >= 1, grid
        assert grid["blocks"] == pe_plan.cluster_blocks(tiles, c, k) <= sms
        sizes.add(c)

    for F, dim, widths, n in K5_STREAM_GPU_CASES.values():
        for need_dx, need_dw in ((True, True), (True, False), (False, True)):
            key = mlp_plan.program_key(dim * (1 + 2 * F), widths, dim, F,
                                       True, need_dx, need_dw)
            held(kmlp.stream_bwd_grid(key, n), n)
    for hidden, hs, wide in ((256, 64, False), (512, 512, True)):
        cfg, params = _field(cuda, hidden_dim=hidden, hidden_dim_semantics=hs)
        base, top, color, sem = [[w.detach() for w in grp] for grp in
                                 fused_field_weights(params.field, cfg.field)]
        for heads in (True, False):
            grp = (base, top, color, sem) if heads else (base, top)
            de = {"de": color[1].shape[0]} if heads else {}
            _, _, meta = kfield.pack_pe_field(3, POS_FREQS, *grp, **de)
            plan = pe_plan.build_plan(meta, heads, False, True)
            assert kfield.bwd_smem_bytes(meta, heads) == \
                pe_plan.bwd_tile_smem(plan.header)[0]
            for need_dw in ((True,) if heads else (True, False)):
                for n in (1, 300, 196_608):
                    held(kfield.bwd_grid(meta, heads, need_dw, n), n, wide)
    assert len(sizes) == 1, sizes


@torch.no_grad()
def test_fused_mlp_stream_deep_net(cuda):
    """K3's stream route at its deepest and widest, 32 layers of 256 with
    256 inputs and outputs, forward and backward, against the plain
    version in float32: in bf16 the roundings compound over the 32 layers
    (the bf16 plain version is 0.24 from float32 in relative L2), so the
    kernel is held to be no further from float32 than the bf16 plain
    version is, times 1.1; dx alone and dW alone are the full backward's
    bits."""
    dims = (256,) + (256,) * 32
    g, wbs = _k3_net(cuda, dims)
    n = 4099
    x = torch.randn((n, 256), generator=g, device=cuda)
    cot = torch.randn((n, 256), generator=g, device=cuda)
    assert kmlp.fused_mlp_route(256, list(dims[1:])) == "stream"
    out = kmlp.fused_mlp(x, wbs)
    dx, dw = kmlp.fused_mlp_bwd(x, wbs, cot, True, True)
    ref = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [x.clone().requires_grad_(True)] + _leaves(wbs, True)
        with torch.enable_grad():
            o = kmlp.fused_mlp_plain(leaves[0], leaves[1:], dtype)
            ref[dtype] = [o.detach()] + list(_grads(o, leaves, cot))
    l2 = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    for i, got in enumerate([out, dx, *dw]):
        f32, bf = ref[torch.float32][i], ref[torch.bfloat16][i]
        assert torch.isfinite(got).all(), i
        assert l2(got, f32) <= 1.1 * l2(bf, f32) + 1e-3, (i, l2(got, f32),
                                                          l2(bf, f32))
    dx_only, _ = kmlp.fused_mlp_bwd(x, wbs, cot, True, False)
    _, dw_only = kmlp.fused_mlp_bwd(x, wbs, cot, False, True)
    assert torch.equal(dx_only, dx)
    assert all(torch.equal(a, b) for a, b in zip(dw_only, dw))


# (num_freqs, hidden width, layers, N) of the wide route's backward:
# cropnerf-mxu-q's nets at a training step's sample counts (4096 rays x 256
# and x 96), a ragged N, N < 64, one row, and a two-layer net 256 wide
K5_WIDE_GPU_CASES = {"q-net0": (5, 128, 3, 1_048_576),
                     "q-net1": (6, 128, 3, 393_216),
                     "q-net0-ragged": (5, 128, 3, 1_048_576 - 77),
                     "q-net1-small": (6, 128, 3, 50),
                     "q-one-row": (5, 128, 3, 1),
                     "two-layers-256": (5, 256, 2, 65_536 + 3)}


@pytest.mark.parametrize("variant", ["dx-dW", "dW-only", "dx-only"])
@pytest.mark.parametrize("case", list(K5_WIDE_GPU_CASES))
def test_fused_pe_mlp_wide_backward_matches_plain(cuda, case, variant):
    """The wide route's backward (the PE variant of csrc/fused_mlp_bwd.cu)
    through autograd, as a training step records it: dx with the weight
    gradients (the proposal samples carry the camera-opt graph), the weight
    gradients alone (positions without a graph) and dx alone; one launch
    of each kernel counted on fused_pe_mlp and fused_pe_mlp_bwd, against
    the plain version, two runs the same bits, and each partial backward
    the full one's bits."""
    F, hidden, layers, n = K5_WIDE_GPU_CASES[case]
    need_dx, need_dw = variant != "dW-only", variant != "dx-only"
    wbs = _prop_net(cuda, F, need_dw, hidden=hidden, layers=layers)
    assert kfield.pe_mlp_fwd_route(3, F, [w.shape[1] for w in wbs[0::2]]) \
        == "wide"
    g = torch.Generator(device=cuda).manual_seed(29)
    x = (torch.rand((n, 3), generator=g, device=cuda) * 2 - 1
         ).requires_grad_(need_dx)
    cot = torch.randn((n, 1), generator=g, device=cuda)
    leaves = ([x] if need_dx else []) + (wbs if need_dw else [])
    before = (kfield.fused_pe_mlp.launches, kfield.fused_pe_mlp_bwd.launches)
    out = kfield.fused_pe_mlp(x, wbs, F)
    got = _grads(out, leaves, cot)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_mlp.launches, kfield.fused_pe_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_out = kfield.fused_pe_mlp_plain(x, wbs, F)
    ref = _grads(ref_out, leaves, cot)
    assert out.shape == (n, 1) and torch.isfinite(out).all()
    assert _rel_err(out.detach(), ref_out.detach()) <= TOL
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, per_row=True) if need_dx and i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kfield.fused_pe_mlp(x, wbs, F), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "the backward kernel is not deterministic"
    wd = [w.detach() for w in wbs]
    dx, dw = kfield.fused_pe_mlp_bwd(x.detach(), wd, F, cot, True, True)
    if need_dx:
        assert torch.equal(got[0], dx)
    if need_dw:
        assert all(torch.equal(a, b) for a, b in zip(got[-len(dw):], dw))


# (num_freqs, widths, N) of the wide backward's other kernels
# (csrc/fused_pe_mlp_wide_bwd.cu, by the encoding's 16-column blocks and
# the operand-tile sets): 63 encoding columns and 16 outputs (one set),
# 9 columns and 3 outputs, a 2-layer net 256 wide at 21 columns
K5_WIDE_NETS = {"63-cols-16-out": (10, [128, 128, 16], 65_536 + 5),
                "9-cols-3-out": (1, [128, 128, 3], 20_000),
                "two-layers-256-21-cols": (3, [256, 2], 7_000)}


@pytest.mark.parametrize("net", list(K5_WIDE_NETS))
def test_fused_pe_mlp_wide_backward_nets_match_plain(cuda, net):
    """K5's wide backward with weight gradients on every operand width it
    instantiates: dx and dW, and dW alone, against autograd of the plain
    version, dW alone the full backward's bits, two runs the same bits."""
    F, widths, n = K5_WIDE_NETS[net]
    assert kfield.pe_mlp_fwd_route(3, F, widths) == "wide"
    g = torch.Generator(device=cuda).manual_seed(31)
    dims = [3 * (1 + 2 * F)] + widths
    wbs = []
    for a, b in zip(dims[:-1], dims[1:]):
        wbs += [torch.randn((a, b), generator=g, device=cuda) / a ** 0.5,
                torch.randn((1, b), generator=g, device=cuda) * 0.1]
    x = torch.rand((n, 3), generator=g, device=cuda) * 2 - 1
    cot = torch.randn((n, widths[-1]), generator=g, device=cuda)
    before = kfield.fused_pe_mlp_bwd.launches
    dx, dw = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, True, True)
    dx2, dw2 = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, True, True)
    _, dw_alone = kfield.fused_pe_mlp_bwd(x, wbs, F, cot, False, True)
    torch.cuda.synchronize()
    assert kfield.fused_pe_mlp_bwd.launches == before + 3
    leaves = _leaves([x, *wbs], True)
    ref = _grads(kfield.fused_pe_mlp_plain(leaves[0], leaves[1:], F), leaves,
                 cot)
    assert _grad_agrees(dx, ref[0], per_row=True)
    for i, (a, b) in enumerate(zip(dw, ref[1:])):
        assert a.shape == b.shape and _weight_grad_agrees(a, b, n), (
            i, _rel_err(a, b))
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dw, dw2))
    assert all(torch.equal(a, b) for a, b in zip(dw, dw_alone))


# ---- K6, the transmittance scan (csrc/transmittance.cu) ----------------------
#
# The kernel scans each row in 32-sample segments where torch.cumsum sums
# in its own order: the weights agree to 1e-5 absolute (they lie in [0, 1]).

@pytest.mark.parametrize("shape", [(4096, 48), (4096, 256), (4096, 96),
                                   (16_384, 3000), (4093, 77), (1, 1)])
@torch.no_grad()
def test_render_weights_kernel_matches_plain(cuda, shape):
    from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
    from cropnerf_tpu_torch.ops.render import render_weights
    R, S = shape
    g = torch.Generator(device=cuda).manual_seed(10)
    density = torch.rand((R, S), generator=g, device=cuda) * 5
    deltas = torch.rand((R, S), generator=g, device=cuda) * 0.1 * 48 / S
    before = render_weights_cuda.launches
    got = render_weights_cuda(density, deltas)
    torch.cuda.synchronize()
    assert render_weights_cuda.launches == before + 1
    ref = render_weights(density, deltas)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-5
    assert torch.equal(got, render_weights_cuda(density, deltas))


def test_render_weights_kernel_refuses_autograd(cuda):
    from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
    density = torch.rand((8, 48), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        render_weights_cuda(density, torch.rand((8, 48), device=cuda))
    empty = density.detach()[:0]
    before = render_weights_cuda.launches
    assert render_weights_cuda(empty, empty).shape == (0, 48)
    assert render_weights_cuda.launches == before


def _propfused(cfg):
    """cropnerf-mxu with both PE proposal nets on the fused kernel, as
    benchmarks/ab_pe_fused.py builds it."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, proposal_fields=tuple(dataclasses.replace(p, mlp_impl="pallas-fused")
                                 for p in m.proposal_fields)))


def test_propfused_train_step_kernel_path_matches_plain_path(cuda):
    """One training step of the fused-proposal path against the plain path
    (field and proposal nets on plain matmuls): K1 forward and backward
    once, K5 forward and backward once per proposal net."""
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import train_loss
    cfg = _propfused(dataclasses.replace(PRESETS["cropnerf-mxu"],
                                         train_num_rays_per_batch=1024))
    m = cfg.model
    plain = dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, mlp_impl="xla"),
        proposal_fields=tuple(dataclasses.replace(p, mlp_impl="xla")
                              for p in m.proposal_fields)))
    bank = _synthetic_bank(cuda)
    kernels = (kfield.fused_pe_nerf, kfield.fused_pe_nerf_bwd,
               kfield.fused_pe_mlp, kfield.fused_pe_mlp_bwd,
               kfield.fused_pe_density, kmlp.fused_mlp)
    results = []
    for c in (cfg, plain):
        state = create_train_state(c, bank.num_images,
                                   torch.Generator().manual_seed(0), cuda)
        gen = torch.Generator(device=cuda).manual_seed(1)
        idx = torch.randint(0, bank.num_pixels, (1024,), generator=gen,
                            device=cuda)
        before = [k.launches for k in kernels]
        loss, _ = train_loss(state.params, bank, idx, 300, c, gen)
        loss.backward()
        torch.cuda.synchronize()
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert launched == ([1, 1, 2, 2, 0, 0] if c is cfg else [0] * 6), launched
        results.append((loss.detach(), {k: p.grad.clone() for k, p in
                                        state.params.named_parameters()}))
    (l_k, g_k), (l_p, g_p) = results
    assert torch.isfinite(l_k) and abs(l_k - l_p) <= 2e-2 * abs(l_p)
    for k in g_p:
        assert torch.isfinite(g_k[k]).all(), k
        assert _rel_err(g_k[k], g_p[k]) <= BWD_TOL, (k, _rel_err(g_k[k], g_p[k]))


# ---- projection: the kernel path against the plain path ---------------------
#
# ClusterProjector at both presets' full widths with random weights and a
# density and a semantic bias, chosen (as tests/test_torch_projection.py
# chooses its reduced fields') so that the images hold semantics, kept
# pixels and occluded ones.  Tolerances of the chip_smoke.py [count]
# phase: the occlusion-free image within 2/255 a pixel, at most 0.5 % of a
# crop's visible pixels flipped (an accumulation near 0.5 takes the other
# side in bf16), the same jobs empty.

PROJ_BIASES = {"cropnerf": (("field.mlp_base.b.1", 0.0),
                            ("field.semantic_head.b.0", 3.0)),
               "cropnerf-mxu": (("field.mlp_top.b.3", 0.0),
                                ("field.mlp_semantic.b.1", 3.0))}
PROJ_LAUNCHES = {"cropnerf": {"hash_encode": 6},
                 "cropnerf-mxu": {"fused_pe_nerf": 1, "fused_pe_density": 1}}
PROJ_BOXES = ([[-0.2, -0.2, -0.2], [0.2, 0.2, 0.2]],      # inside the frame
              [[2.4, -0.1, 0.2], [2.8, 0.1, 0.5]],        # behind camera 0
              [[0.0, 0.0, 0.0], [0.002, 0.002, 0.002]],   # under 10 hits
              [[-0.6, -0.6, -0.6], [0.6, 0.6, 0.6]])      # most of the frame


def _ring_cameras(cuda, n, h, w, focal):
    import numpy as np
    from cropnerf_tpu_torch.core.cameras import Cameras
    c2w = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        eye = np.array([1.2 * np.cos(theta), 1.2 * np.sin(theta), 0.3])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w.append(np.concatenate([np.stack(
            [right, np.cross(right, fwd), -fwd], axis=1), eye[:, None]], 1))
    full = lambda v: torch.full((n,), v, device=cuda)  # noqa: E731
    return Cameras(c2w=torch.tensor(np.stack(c2w), dtype=torch.float32,
                                    device=cuda),
                   fx=full(focal), fy=full(focal), cx=full(w / 2.0),
                   cy=full(h / 2.0), width=full(w).long(),
                   height=full(h).long())


def _projection_scene(cuda, preset, n_cams=4):
    import numpy as np
    cfg = PRESETS[preset]
    params = model_init(cfg.model, n_cams, torch.Generator().manual_seed(0),
                        cuda)
    named = dict(params.named_parameters())
    with torch.no_grad():
        for name, bias in PROJ_BIASES[preset]:
            named[name][0] += bias
    plain = (_plain_grid(cfg) if preset == "cropnerf" else
             dataclasses.replace(cfg, model=dataclasses.replace(
                 cfg.model, field=dataclasses.replace(cfg.model.field,
                                                      mlp_impl="xla"))))
    jobs = [(c, np.array(b, np.float32)) for c in range(n_cams)
            for b in PROJ_BOXES]
    return cfg.model, plain.model, params, jobs


def _project_counted(proj, jobs):
    from cropnerf_tpu_torch.ops.cuda import hash_encode as khash
    counters = (kfield.fused_pe_nerf, kfield.fused_pe_density,
                kmlp.fused_mlp, kmlp.fused_mlp_stream, khash.hash_encode,
                kfield.fused_pe_mlp)
    for k in counters:
        k.launches = 0
    out = {i: (w, v) for i, w, v in proj.iter_projections(jobs)}
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in counters}


def _images_agree(got, ref, plan):
    for job in plan.jobs:
        (w, v), (rw, rv) = got[job.index], ref[job.index]
        assert abs(w - rw).max() <= 2 / 255, job.index
        assert ((v > 0) != (rv > 0)).sum() <= 0.005 * job.n_pix, job.index
    assert ({i for i, (w, _) in got.items() if not w.any()}
            == {i for i, (w, _) in ref.items() if not w.any()})


@pytest.mark.parametrize("preset", ["cropnerf", "cropnerf-mxu"])
def test_projection_kernel_path_matches_plain_path(cuda, preset):
    """The kernel path against the plain path on the same jobs, with each
    kernel of the path launched exactly its count a dispatch and nothing
    else launched; the plain path launches nothing."""
    from cropnerf_tpu_torch.projection.project import ClusterProjector
    model, plain, params, jobs = _projection_scene(cuda, preset)
    cams = _ring_cameras(cuda, 4, 480, 640, 600.0)
    results = {}
    for name, cfg in (("kernel", model), ("plain", plain)):
        proj = ClusterProjector(params, cfg, cams, 480, 640)
        plan = proj.plan(jobs)
        results[name], launches = _project_counted(proj, jobs)
        want = {k: (PROJ_LAUNCHES[preset].get(k, 0) * len(plan.dispatches)
                    if name == "kernel" else 0) for k in launches}
        assert launches == want, (name, launches, want)
    assert 1 in plan.outside and len(plan.dispatches) > 1
    _images_agree(results["kernel"], results["plain"], plan)
    kept = sum(int((v > 0).sum()) for _, v in results["kernel"].values())
    assert kept > 0
    # the box under 10 hits gives zero images from every camera
    assert not any(results["kernel"][i][0].any() for i in (2, 6, 10, 14))


@pytest.mark.parametrize("preset", ["cropnerf", "cropnerf-mxu"])
def test_projection_row_segments_match_one_dispatch(cuda, preset):
    """A samples budget of 4096 rays a dispatch renders every crop in row
    segments; the images agree with the default budget's."""
    from cropnerf_tpu_torch.projection.project import ClusterProjector
    model, _, params, jobs = _projection_scene(cuda, preset)
    cams = _ring_cameras(cuda, 4, 480, 640, 600.0)
    spr = (model.num_nerf_samples_per_ray
           + sum(model.num_proposal_samples_per_ray))
    one = ClusterProjector(params, model, cams, 480, 640)
    seg = ClusterProjector(params, model, cams, 480, 640,
                           max_samples_per_dispatch=4096 * spr)
    assert seg.max_rays_per_job == 4096
    plan = seg.plan(jobs)
    assert max(j.n_pix for j in plan.jobs) > 4096
    ref, _ = _project_counted(one, jobs)
    got, launches = _project_counted(seg, jobs)
    for k, n in PROJ_LAUNCHES[preset].items():
        assert launches[k] == n * len(plan.dispatches)
    _images_agree(got, ref, plan)


# --- 512 wide: the tile kernels' wide programs ([w512]) -----------------------
#
# A layer over 256 wide makes a program wide: every product's columns in
# halves, the forward's over a cluster of two blocks (each warpgroup on its
# own 64 rows of a 128-row tile), the backward's between a block's two
# warpgroups on one 64-row half at a time.  Row counts: one row, either
# side of a warpgroup's 64 rows and of a 128-row tile, 300 (a tile whose
# second warpgroup has 44 rows), an export chunk less a ragged tail and a
# training step's field samples (4096 rays x 48).
W512_N = [1, 63, 65, 129, 300, 65_536 - 45, 196_608]


def _w512_field(cuda):
    """[w512]'s field: cropnerf-mxu with a 512-wide trunk and semantic
    head, its colour head 64 wide."""
    cfg, params = _field(cuda, hidden_dim=512, hidden_dim_semantics=512)
    groups = fused_field_weights(params.field, cfg.field)
    assert groups[0][0].shape[1] == 512 and groups[3][0].shape[1] == 512
    return groups


@pytest.mark.parametrize("n", W512_N)
def test_fused_pe_nerf_w512_matches_plain(cuda, n):
    """K1 forward and backward at [w512]'s widths (wide programs) against
    the plain version and its autograd, one launch each way; two runs give
    the same bits.  The heads read t rounded to bf16, and where the
    kernel's t and the plain version's lie on either side of a rounding
    boundary (sums in another order) the 512-wide semantic head moves that
    row's logit by up to ~2 % of the largest; so rgb_raw and sem_raw are
    held to TOL against the plain heads on the kernel's own t
    (``heads_plain``), and in relative L2 to TOL against the plain
    version."""
    _check_wide_nerf(cuda, n, _w512_field(cuda))


def _check_wide_nerf(cuda, n, groups, plain_f32=None):
    """test_fused_pe_nerf_w512_matches_plain's checks on the field
    ``groups``; with ``plain_f32`` (a callable giving the float32 plain
    version's outputs) the gradients are held to W1024_GRAD_TOL and
    _no_further_from_f32."""
    base, top, color, sem = [_leaves(grp, True) for grp in groups]
    x, extras = _field_inputs(n, color[1].shape[0], cuda, seed=31)
    x.requires_grad_(True)
    extras.requires_grad_(True)
    wbs = [*base, *top, *color, *sem]
    before = (kfield.fused_pe_nerf.launches, kfield.fused_pe_nerf_bwd.launches)
    got = kfield.fused_pe_nerf(x, extras, base, top, color, sem, POS_FREQS)
    ref = kfield.fused_pe_nerf_plain(x, extras, base, top, color, sem,
                                     POS_FREQS)
    with torch.no_grad():
        on_t = kfield.heads_plain(got[0], extras, color, sem)
    assert _rel_err(got[0], ref[0]) <= TOL, ("t", _rel_err(got[0], ref[0]))
    for name, a, b, c in zip(("rgb_raw", "sem_raw"), got[1:], ref[1:], on_t):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel_err(a, c) <= TOL, (name, _rel_err(a, c))
        assert ((a - b).norm() / b.norm()).item() <= TOL, name
    g = torch.Generator(device=cuda).manual_seed(5)
    cots = [torch.randn(o.shape, generator=g, device=cuda) for o in ref]
    got_g = _grads(got, [x, extras, *wbs], cots)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_nerf.launches,
            kfield.fused_pe_nerf_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_g = _grads(ref, [x, extras, *wbs], cots)
    tol = BWD_TOL
    if plain_f32 is not None:
        f32 = _grads(plain_f32(x, extras, base, top, color, sem),
                     [x, extras, *wbs], cots)
        _no_further_from_f32(got_g, ref_g, f32)
        tol = W1024_GRAD_TOL
    for i, (a, b) in enumerate(zip(got_g, ref_g)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, True, tol) if i < 2
              else _weight_grad_agrees(a, b, n, tol))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kfield.fused_pe_nerf(x, extras, base, top, color, sem,
                                        POS_FREQS), [x, extras, *wbs], cots)
    assert all(torch.equal(a, b) for a, b in zip(got_g, again)), \
        "the backward kernel is not deterministic"


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("n", W512_N)
def test_fused_pe_density_w512_matches_plain(cuda, n, need_dw):
    """K2 forward and backward at [w512]'s trunk (wide programs), with the
    weight gradients and with dx alone (the BayesRays pass, bit-equal to
    the full backward's dx), one launch each way; two runs give the same
    bits."""
    _check_wide_density(cuda, n, need_dw, _w512_field(cuda))


def _check_wide_density(cuda, n, need_dw, groups, plain_f32=False):
    """test_fused_pe_density_w512_matches_plain's checks on the field
    ``groups``; with ``plain_f32`` the gradients are held to
    W1024_GRAD_TOL and _no_further_from_f32."""
    base, top, _, _ = groups
    base, top = _leaves(base, need_dw), _leaves(top, need_dw)
    x, _ = _field_inputs(n, 1, cuda, seed=32)
    x.requires_grad_(True)
    leaves = [x] + (base + top if need_dw else [])
    cot = torch.randn((n, top[-2].shape[1]), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(6))
    before = (kfield.fused_pe_density.launches,
              kfield.fused_pe_density_bwd.launches)
    out = kfield.fused_pe_density(x, base, top, POS_FREQS)
    ref_out = kfield.fused_pe_density_plain(x, base, top, POS_FREQS)
    assert _rel_err(out.detach(), ref_out.detach()) <= TOL
    got = _grads(out, leaves, cot)
    torch.cuda.synchronize()
    assert (kfield.fused_pe_density.launches,
            kfield.fused_pe_density_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref = _grads(ref_out, leaves, cot)
    tol = BWD_TOL
    if plain_f32:
        f32 = _grads(kfield.fused_pe_density_plain(x, base, top, POS_FREQS,
                                                   torch.float32), leaves, cot)
        _no_further_from_f32(got, ref, f32)
        tol = W1024_GRAD_TOL
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, True, tol) if i == 0
              else _weight_grad_agrees(a, b, n, tol))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kfield.fused_pe_density(x, base, top, POS_FREQS), leaves,
                   cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if not need_dw:
        full = _grads(kfield.fused_pe_density(x, _leaves(base, True),
                                              _leaves(top, True), POS_FREQS),
                      [x], cot)
        assert torch.equal(full[0], got[0])


# [w1024]: K1 and K2 at a 1024-wide trunk (width class 2: both warpgroups on
# a 64-row tile, 1024-wide products in two passes): one row, a warpgroup's
# rows either side, a ragged 300, an export chunk less a tail, a training
# step's field samples
W1024_N = [1, 63, 65, 300, 65_536 - 45, 196_608]


# [w1024]'s gradients against the bf16 plain version.  Where the two bf16
# versions round a relu unit apart (sums in another order, bf16(t) to the
# other neighbour in the heads), more rows part at a 1024-wide trunk than
# at 512: one row of 63 moves past BWD_TOL, K1's semantic head's gradients
# measured up to 7.88e-2 in relative L2 at 196,608 rows and K2's weight
# gradients 8.67e-2 at 128 (chip_smoke.py; NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md §6, [w1024]).  So they are held as the [w512] gradients are, to
# W1024_GRAD_TOL in place of BWD_TOL; and each besides no further in
# relative L2 from the float32 plain version than the bf16 plain version
# is, plus W1024_L2_MARGIN (both bf16 versions lie up to ~14 % from
# float32; the kernel measured at most 3.4e-3 further)
W1024_GRAD_TOL = 1e-1
W1024_L2_MARGIN = 1e-2


def _no_further_from_f32(got, plain, f32) -> None:
    """The kernel's gradients ``got`` no further from the float32 plain
    version's ``f32`` in relative L2 than the bf16 plain version's
    ``plain`` are, plus W1024_L2_MARGIN."""
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-12)).item()  # noqa: E731
    for i, (a, p, f) in enumerate(zip(got, plain, f32)):
        assert rel(a, f) <= rel(p, f) + W1024_L2_MARGIN, (i, rel(a, f), rel(p, f))


def _w1024_field(cuda):
    """[w1024]'s field: cropnerf-mxu with a 1024-wide trunk, its heads 64
    wide."""
    cfg, params = _field(cuda, hidden_dim=1024)
    groups = fused_field_weights(params.field, cfg.field)
    assert groups[0][0].shape[1] == 1024 and groups[3][0].shape[1] == 64
    return groups


@pytest.mark.parametrize("n", W1024_N)
def test_fused_pe_nerf_w1024_matches_plain(cuda, n):
    """K1 forward and backward at [w1024]'s field (class 2) against the
    plain version and its autograd, as at [w512] (one launch each way, two
    runs the same bits, the heads against the plain heads on the kernel's
    own t), the gradients against the float32 plain version
    (W1024_GRAD_TOL, _no_further_from_f32)."""
    _check_wide_nerf(cuda, n, _w1024_field(cuda),
                     lambda *a: kfield.fused_pe_nerf_plain(*a, POS_FREQS,
                                                           torch.float32))


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("n", W1024_N)
def test_fused_pe_density_w1024_matches_plain(cuda, n, need_dw):
    """K2 forward and backward at [w1024]'s trunk (class 2), with the weight
    gradients and with dx alone (bit-equal to the full backward's dx), one
    launch each way; two runs give the same bits; the gradients against
    the float32 plain version (W1024_GRAD_TOL, _no_further_from_f32)."""
    _check_wide_density(cuda, n, need_dw, _w1024_field(cuda), True)


def test_w1024_layouts_grids_and_refusal(cuda):
    """[w1024]'s K1 and K2 programs: the C layouts are pe_plan's mirrors
    (fwd_smem, bwd_tile_smem) and fit a block; the forward runs persistent
    blocks over 64-row tiles (one an SM up to the tiles, no cluster), the
    backward's tile kernel persistent clusters of CLUSTER blocks, no more
    blocks than SMs (its relu masks hold a block's words for each SM); a
    1040-wide trunk raises on the card before a launch, with its width in
    the message."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    base, top, color, sem = [[w.detach() for w in grp]
                             for grp in _w1024_field(cuda)]
    _, _, meta = kfield.pack_pe_field(3, POS_FREQS, base, top, color, sem,
                                      de=color[1].shape[0])
    for heads in (True, False):
        h = pe_plan.build_forward_plan(meta, heads).header
        assert pe_plan.width_class([h[pe_plan.H_ACT_W]]) == 2
        assert kfield.smem_bytes(meta, heads) == pe_plan.fwd_smem(h)[0] <= 232_448
        for need_dw in ((True,) if heads else (True, False)):
            hb = pe_plan.build_plan(meta, heads, False, need_dw).header
            assert kfield.bwd_smem_bytes(meta, heads) == pe_plan.bwd_tile_smem(hb)[0]
            for n in (1, 300, 196_608):
                grid = kfield.bwd_grid(meta, heads, need_dw, n)
                k = grid["active_clusters"]
                assert grid["error"] == 0 and grid["cluster"] == 2 and k >= 1
                assert grid["blocks"] == 2 * min(k, -(-(-(-n // 128)) // 2)) <= sms
        for n in (1, 300, 196_608):
            assert kfield.fwd_grid(meta, heads, n) == dict(
                cluster=0, active_clusters=0, blocks=min(-(-n // 64), sms),
                error=0)
    cfg, params = _field(cuda, hidden_dim=1040)
    wide = [[w.detach() for w in grp]
            for grp in fused_field_weights(params.field, cfg.field)]
    x = torch.zeros((64, 3), device=cuda)
    before = (kfield.fused_pe_density.launches, kfield.fused_pe_nerf.launches)
    with pytest.raises(ValueError, match="1040"):
        kfield.fused_pe_density(x, wide[0], wide[1], POS_FREQS)
    with pytest.raises(ValueError, match="1040"):
        kfield.fused_pe_nerf(x, torch.zeros((64, wide[2][1].shape[0]), device=cuda),
                             *wide, POS_FREQS)
    assert (kfield.fused_pe_density.launches,
            kfield.fused_pe_nerf.launches) == before


# K3 on the stream route's wide programs: [w512]'s semantic head (its export
# and BayesRays batches) and a 512-wide net on 512 inputs
K3_W512 = {"semantic-512": (15, 512, 1), "din-512": (512, 512, 16)}


@pytest.mark.parametrize("need_dw", [True, False], ids=["with-dW", "dx-only"])
@pytest.mark.parametrize("n", [1, 65, 129, 262_144 - 3])
@pytest.mark.parametrize("net", list(K3_W512))
def test_fused_mlp_stream_w512_matches_plain(cuda, net, n, need_dw):
    """K3's stream route at 512 wide, forward and backward, one launch
    each way on the stream counters; dx alone and dW alone are the full
    backward's bits; two runs give the same bits."""
    dims = K3_W512[net]
    g, wbs = _k3_net(cuda, dims)
    assert kmlp.fused_mlp_route(dims[0], list(dims[1:])) == "stream"
    wbs = _leaves(wbs, need_dw)
    x = torch.randn((n, dims[0]), generator=g, device=cuda, requires_grad=True)
    cot = torch.randn((n, dims[-1]), generator=g, device=cuda)
    leaves = [x] + (wbs if need_dw else [])
    before = _k3_launches()
    out = kmlp.fused_mlp(x, wbs)
    ref_out = kmlp.fused_mlp_plain(x, wbs)
    assert _rel_err(out.detach(), ref_out.detach()) <= TOL
    got = _grads(out, leaves, cot)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_k3_launches(), before)] == [0, 1, 0, 1]
    ref = _grads(ref_out, leaves, cot)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        ok = (_grad_agrees(a, b, per_row=True) if i == 0
              else _weight_grad_agrees(a, b, n))
        assert ok, (i, _rel_err(a, b))
    again = _grads(kmlp.fused_mlp(x, wbs), leaves, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with torch.no_grad():
        dx, dw = kmlp.fused_mlp_bwd(x, wbs, cot, True, True)
        dx_only, _ = kmlp.fused_mlp_bwd(x, wbs, cot, True, False)
        _, dw_only = kmlp.fused_mlp_bwd(x, wbs, cot, False, True)
    assert torch.equal(dx_only, dx)
    assert all(torch.equal(a, b) for a, b in zip(dw_only, dw))



def test_wide_forwards_run_as_split_clusters(cuda):
    """The wide forwards (K1 and K2 at [w512]'s field, the stream route's
    K5 nets and K3 head at 512 wide) run as persistent clusters of CLUSTER
    (2) blocks (csrc/pe_tile.cuh cluster_launch, a 128-row tile a
    cluster): at least one resident, as many clusters as tiles up to the
    resident count, no more blocks than SMs; the forwards up to 256 wide
    keep persistent
    blocks, one an SM up to the tiles.  The C layout of K1's and K2's
    forward is pe_plan.fwd_smem's."""
    from cropnerf_tpu_torch.ops.cuda import mlp_plan
    from cropnerf_tpu_torch.ops.cuda import pe_plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def held(grid, n, wide):
        tiles = -(-n // 128)
        if not wide:
            assert grid == dict(cluster=0, active_clusters=0,
                                blocks=min(tiles, sms), error=0), grid
            return
        k = grid["active_clusters"]
        c = pe_plan.CLUSTER
        assert grid["error"] == 0 and grid["cluster"] == c and k >= 1, grid
        assert grid["blocks"] == c * min(k, tiles) <= sms, grid

    for hidden, hs, wide in ((256, 64, False), (512, 512, True)):
        cfg, params = _field(cuda, hidden_dim=hidden, hidden_dim_semantics=hs)
        base, top, color, sem = [[w.detach() for w in grp] for grp in
                                 fused_field_weights(params.field, cfg.field)]
        for heads in (True, False):
            grp = (base, top, color, sem) if heads else (base, top)
            de = {"de": color[1].shape[0]} if heads else {}
            _, _, meta = kfield.pack_pe_field(3, POS_FREQS, *grp, **de)
            h = pe_plan.build_forward_plan(meta, heads).header
            assert kfield.smem_bytes(meta, heads) == pe_plan.fwd_smem(h)[0]
            for n in (1, 300, 196_608):
                held(kfield.fwd_grid(meta, heads, n), n, wide)
    for din, widths, dim, F in ((33, [512, 512, 1], 3, 5),
                                (39, [512, 512, 1], 3, 6),
                                (15, [512, 1], 0, 0),
                                (39, [256, 256, 1], 3, 6)):
        key = mlp_plan.program_key(din, widths, dim, F, False)
        for n in (1, 300, 1_048_576):
            held(kmlp.stream_fwd_grid(key, n), n, max(widths) > 256)

def test_w512_layouts_fit_and_refuse_past_512(cuda):
    """[w512]'s K1 and K2 programs fit a block's shared memory forward and
    backward; a 513-wide layer has no kernel on any route and raises
    before a launch, with its width in the message."""
    base, top, color, sem = [[w.detach() for w in grp]
                             for grp in _w512_field(cuda)]
    _, _, meta = kfield.pack_pe_field(3, POS_FREQS, base, top, color, sem,
                                      de=color[1].shape[0])
    for heads in (True, False):
        assert 0 < kfield.smem_bytes(meta, heads) <= 232_448
        assert 0 < kfield.bwd_smem_bytes(meta, heads) <= 232_448
    x = torch.zeros((64, 15), device=cuda)
    _, wbs = _k3_net(cuda, (15, 513, 1))
    before = _k3_launches()
    with pytest.raises(ValueError, match="513"):
        kmlp.fused_mlp(x, wbs)
    assert _k3_launches() == before
