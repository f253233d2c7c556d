"""The stream route of K3 and K5 (``csrc/fused_mlp_stream.cu``, planned by
``ops/cuda/mlp_plan.py``): the nets the resident-weight wgmma kernels do
not take, forward and backward, against the JAX package on the CPU.

The kernels run only on the card (``tests/test_torch_gpu.py``).  Here a
CPU model runs their programs op by op in torch on what the wrapper hands
them (``_stream_model``): the weight image and padded biases gathered
from the weights (read back as each product's B operand), 128-row tiles,
relu masks from the recompute, cotangents rounded to the compute dtype as
product operands, each A_l and G_l in its workspace slot, the
weight-gradient tasks over the workspace's splits and the per-block bias
sums.  The model runs every net of ``test_torch_propfused.py``'s and
``test_torch_fused_mlp.py``'s route tables that is on the stream route,
and is held against the JAX kernels' VJP: K5's ``fused_pe_mlp`` through
its jnp path (the ``_plain_ref`` VJP) or in interpret mode on 128-row
tiles, K3's ``fused_mlp`` in interpret mode: the float32 arm to 1e-4 of
the largest value, the bf16 arm the output to 2e-2 and the gradients as
``test_stream_programs_match_jax`` says.  Then the slice as a whole:
``cropnerf-mxu-q`` with both PE proposal nets fused at 256 wide
(``[prop256]``), one training step against JAX's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas import fused_pe_field as jfield
from cropnerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
from cropnerf_tpu_torch.ops.cuda import mlp_plan as mp
from cropnerf_tpu_torch.ops.cuda import pe_plan as P
from torch_parity import arm, np_wbs, to_jax, to_torch  # noqa: F401

def _images(wbs, key, dtype):
    """``mlp_plan.stream_images`` in ``dtype`` (bf16 as on the card, float32
    for the f32 arm): the same gather, rounded or not."""
    img_at, bias_at, zero = mp._gather(tuple(tuple(t.shape) for t in wbs), key,
                                       torch.device("cpu"))
    flat = torch.cat([t.reshape(-1) for t in wbs] + [zero]).float()
    return flat.index_select(0, img_at).to(dtype), flat.index_select(0, bias_at)


def _stream_model(x, wbs, F=None, g=None, need_dx=True, need_dw=True,
                  dtype=torch.bfloat16):
    """The stream kernels' programs in torch.  K3 on x [N, din] with F
    None, else K5 on x [N, dim] with F frequencies.  Without g the forward
    program: returns the [N, dout] output.  With the cotangent g the
    backward program and the weight-gradient pass: returns (dx or None,
    [dW0, db0, ...] or None)."""
    din, widths = wbs[0].shape[0], [w.shape[1] for w in wbs[0::2]]
    dim = x.shape[1] if F is not None else 0
    backward = g is not None
    key = mp.program_key(din, widths, dim, F or 0, backward, need_dx, need_dw)
    plan = mp.stream_plan(key)
    h = plan.header
    img, bias = _images(wbs, key, dtype)
    N, in_pad = x.shape[0], h[mp.M_IN_PAD]
    n_pad = -(-N // P.TILE) * P.TILE
    rows = torch.arange(n_pad)
    xs = torch.zeros((n_pad, x.shape[1]))
    xs[:N] = x
    a0 = torch.zeros((n_pad, in_pad))
    a0[:, :din] = tfield._encode(xs, F) if dim else xs
    bufs = {mp.IN: a0.to(dtype),
            mp.ACT: torch.zeros((n_pad, h[mp.M_ACT_W]), dtype=dtype)}
    ws = torch.zeros(h[mp.M_WS_COLS] * n_pad + P.BLOCK * P.DW_M, dtype=dtype)

    def store(col, t):
        if col >= 0:
            ws[P.ws_index(col, t.shape[1], n_pad, rows,
                          torch.arange(t.shape[1]))] = t.to(dtype)

    store(h[mp.M_IN_SLOT], bufs[mp.IN])
    masks, out = {}, None
    bpart = torch.zeros((n_pad // P.BLOCK, h[mp.M_TOTAL_B]))
    dx = torch.zeros((n_pad, din)) if need_dx else None
    genc = torch.zeros((n_pad, in_pad))

    def emit_g(op, v):
        if op[P.O_MASK] >= 0:
            v = torch.where(masks[op[P.O_MASK]], v, 0.0)
        n = op[P.O_N]
        bufs[mp.ACT][:, :n] = v.to(dtype)
        if op[P.O_BOFF] >= 0:
            b, nv = op[P.O_BOFF], op[P.O_NVALID]
            bpart[:, b:b + nv] = v.reshape(-1, P.BLOCK, n).sum(1)[:, :nv]
        store(op[P.O_WS], bufs[mp.ACT][:, :n])

    for op in plan.ops:
        kind, n, K = op[P.O_KIND], op[P.O_N], op[P.O_K]
        if kind == P.EMIT:
            v = torch.zeros((n_pad, n))
            v[:N, :g.shape[1]] = g
            emit_g(op, v)
            continue
        b = P.from_core_k_major(img[op[P.O_IMG]:op[P.O_IMG] + K * n], K, n)
        acc = bufs[op[P.O_A0]][:, :K].float() @ b.float()
        epi = op[P.O_EPI]
        if kind == P.FWD:
            nv = op[P.O_NVALID]
            acc[:, :nv] += bias[op[P.O_BOFF]:op[P.O_BOFF] + nv]
            if epi == mp.Y_OUT:
                out = acc[:N, :h[mp.M_DOUT]]
                continue
            hb = torch.relu(acc).to(dtype)
            bufs[mp.ACT][:, :n] = hb
            if op[P.O_MASK] >= 0:
                masks[op[P.O_MASK]] = hb.float() > 0
            store(op[P.O_WS], hb)
        elif epi == mp.G_MASKED:
            emit_g(op, acc)
        else:
            c = op[P.O_COL]
            if epi == mp.DX:
                if c < din:
                    dx[:, c:c + n] = acc[:, :min(n, din - c)]
            else:
                genc[:, c:c + n] = acc
    if not backward:
        return out
    if need_dx and dim:
        col = torch.arange(din)
        sel = torch.from_numpy(tfield.pe_selector_matrix(F, dim=dim))
        pre = xs @ sel
        sin_end = dim * (1 + F)
        gd = genc[:, :din]
        d_pre = torch.where(col < dim, gd,
                            torch.where(col < sin_end, gd * torch.cos(pre),
                                        -gd * torch.sin(pre)))
        dx = d_pre @ sel.T
    if need_dx:
        dx = dx[:N]
    if not need_dw:
        return dx, None
    splits, per = P.dw_splits(N, len(plan.tasks))
    wpart = torch.zeros((splits, h[mp.M_TOTAL_W]))
    for sp in range(splits):                  # split-K pass: Aᵀ·G per task
        r = rows[sp * per * P.BLOCK:(sp + 1) * per * P.BLOCK]
        for t in plan.tasks:
            m, nn, j0 = t[P.T_M_VALID], t[P.T_N], t[P.T_J0]
            cols = min(t[P.T_BN], nn - j0)
            a = ws[P.ws_index(t[P.T_A_COL], t[P.T_A_W], n_pad, r,
                              t[P.T_I0] + torch.arange(m))]
            gg = ws[P.ws_index(t[P.T_G_COL], t[P.T_G_W], n_pad, r,
                               j0 + torch.arange(cols))]
            o = t[P.T_W_OFF] + t[P.T_W_ROW0] * nn
            wpart[sp, o:o + m * nn].view(m, nn)[:, j0:j0 + cols] = (
                a.float().T @ gg.float())
    return dx, tmlp.unpack_stream_grads(wbs, wpart.sum(0), bpart.sum(0))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


# the nets of the route tables on the stream route: (x's columns, F or
# None for K3, output widths, rows, JAX in interpret mode)
STREAM_NETS = {
    "k5-69-columns": (3, 11, [64, 64, 1], 300, False),
    "k5-4-layers": (3, 5, [64, 64, 64, 1], 256, True),
    "k5-17-outputs": (3, 5, [64, 64, 17], 300, False),
    "k5-x2": (2, 5, [64, 64, 1], 300, False),
    "k5-256-wide": (3, 5, [256, 256, 1], 300, False),
    "k5-69-columns-128": (3, 11, [128, 128, 1], 300, False),
    "k5-4-layers-128": (3, 5, [128, 128, 128, 1], 300, False),
    "k5-x2-128": (2, 5, [128, 128, 1], 300, False),
    "k3-huge-colour-2": (89, None, [256, 256, 3], 256, True),
    "k3-semantic-256": (30, None, [256, 256, 1], 256, True),
    "k3-6-layers": (40, None, [128] * 5 + [7], 256, True),
    "k5-512-wide": (3, 5, [512, 512, 1], 300, False),
    "k3-semantic-512": (15, None, [512, 1], 256, True),
    "k3-512-din-512": (512, None, [512, 16], 256, True),
}


@pytest.mark.parametrize("case", list(STREAM_NETS))
def test_stream_programs_match_jax(case, arm):
    """Both programs of each stream net, on 256 or 300 rows (a ragged
    last tile): the output, dx and every weight and bias gradient against
    the JAX VJP.  The float32 arm holds each to 1e-4 of its largest value.
    In the bf16 arm XLA sums in another order, so some bf16 activations
    round to the other neighbour and their rows' relu masks differ (17 of
    256 rows of the 256-wide K3 net, 12 % of max dx; deeper nets and K5's
    high frequencies magnify it), and autograd of the port's plain version
    differs from JAX's VJP as much.  There the output is held to 2e-2 of
    max, everything to 1e-2 of max against autograd of the plain version,
    which rounds where the model does, and every gradient's relative L2
    distance to JAX's to the plain version's plus 1e-2."""
    cols, F, widths, n, interpret = STREAM_NETS[case]
    assert (tmlp.fused_mlp_route(cols, widths) if F is None else
            tfield.pe_mlp_fwd_route(cols, F, widths)) == "stream"
    rng = np.random.default_rng(60 + len(case))
    din = cols if F is None else cols * (1 + 2 * F)
    x = (rng.standard_normal((n, cols)) if F is None
         else rng.uniform(-1, 1, (n, cols))).astype(np.float32)
    wbs = np_wbs(rng, [din, *widths])
    cot = rng.standard_normal((n, widths[-1])).astype(np.float32)
    if F is None:
        fn = lambda x, w: jax_fused_mlp(x, w, 128, True)  # noqa: E731
    else:
        s = jnp.asarray(jfield.pe_selector_matrix(F, dim=cols))
        fn = lambda x, w: jfield.fused_pe_mlp(  # noqa: E731
            x, s, w, F, 128, interpret, cols, 128)
    ref, vjp = jax.vjp(fn, jnp.asarray(x), to_jax(wbs))
    jgrads = [np.asarray(r) for r in (lambda d, w: [d, *w])(
        *vjp(jnp.asarray(cot)))]
    xt, wt = torch.from_numpy(x), to_torch(wbs)
    out = _stream_model(xt, wt, F, dtype=arm.dtype)
    dx, grads = _stream_model(xt, wt, F, torch.from_numpy(cot),
                              dtype=arm.dtype)
    assert _rel(out, ref) <= arm.tol, "out"
    if arm.name == "f32":
        for i, (got, r) in enumerate(zip([dx, *grads], jgrads)):
            assert _rel(got, r) <= arm.tol, (i, _rel(got, r))
        return
    leaves = [t.clone().requires_grad_(True) for t in (xt, *wt)]
    plain = (tmlp.fused_mlp_plain(leaves[0], leaves[1:]) if F is None else
             tfield.fused_pe_mlp_plain(leaves[0], leaves[1:], F))
    pgrads = torch.autograd.grad(plain, leaves, torch.from_numpy(cot))
    assert _rel(out, plain.detach()) <= 1e-2, "out vs plain"
    for i, (got, p, r) in enumerate(zip([dx, *grads], pgrads, jgrads)):
        assert _rel(got, p) <= 1e-2, (i, _rel(got, p))
        l2 = np.linalg.norm(r)
        model, torch_plain = (np.linalg.norm(t.numpy() - r) / l2
                              for t in (got, p))
        assert model <= torch_plain + 1e-2, (i, model, torch_plain)


@pytest.mark.parametrize("variant", ["dx", "dw"])
def test_stream_backward_variants_give_the_full_backward(variant):
    """dx alone and the weight gradients alone are the full backward's: the
    programs differ only in the ops and slots they leave out."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (200, 3)).astype(np.float32))
    wt = to_torch(np_wbs(rng, [33, 256, 256, 1]))
    cot = torch.from_numpy(rng.standard_normal((200, 1)).astype(np.float32))
    dx, grads = _stream_model(x, wt, 5, cot)
    got_dx, got_w = _stream_model(x, wt, 5, cot, need_dx=variant == "dx",
                                  need_dw=variant == "dw")
    if variant == "dx":
        assert got_w is None and torch.equal(got_dx, dx)
    else:
        assert got_dx is None
        assert all(torch.equal(a, b) for a, b in zip(got_w, grads))


# (din, F or None, widths): every layout the route takes fits a block's
# shared memory, forward (three slab stages: of 64 rows, or for a net over
# 256 wide 32 rows of a block's 256-column half) and backward (of 32 rows
# or 16: three
# stages up to 256 wide, for two wgmma groups in flight and the
# warpgroups' hand-over; two when wide)
SMEM_EDGES = [(256, None, [256] * 32), (256, None, [256] * 31 + [1]),
              (244, (4, 30), [256] * 32), (244, (4, 30), [256, 256, 1]),
              (1, None, [1]), (15, None, [1]), (3, (3, 0), [16, 1]),
              (512, None, [512] * 32), (512, None, [512] * 31 + [1]),
              (244, (4, 30), [512] * 32), (33, (3, 5), [512, 512, 1]),
              (512, None, [16, 1]), (1, None, [512]), (15, None, [257, 1])]


@pytest.mark.parametrize("case", range(len(SMEM_EDGES)))
def test_stream_layouts_fit_shared_memory(case):
    din, pe, widths = SMEM_EDGES[case]
    dim, F = pe or (0, 0)
    assert mp.stream_takes(din, widths, dim, F)
    for backward in (False, True):
        plan = mp.build_stream_plan(din, widths, dim, F, backward=backward)
        wide = mp.stream_wide(plan.header)
        stages = (mp.MIN_FWD_STAGES if not backward
                  else 2 if wide else mp.MIN_BWD_STAGES)
        smem, got = mp.stream_smem(plan.header, backward)
        assert smem <= tmlp.MAX_SMEM_BYTES and got >= stages, (backward, got)


# the tile counts of the persistent clusters' walk (csrc/pe_tile.cuh
# ClusterWalk): one tile, a cluster's worth, one past it, a ragged last
# group, and [w512]'s 1,048,576-row net (8192 tiles) and one tile more
WALK_TILES = [1, 2, 3, 131, 8192, 8193]


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("n_tiles", WALK_TILES)
def test_cluster_walk_takes_every_tile_once(n_tiles, cluster):
    """The backwards' persistent clusters, at one resident cluster, a few
    and a card's worth (132 SMs): every real tile is taken exactly once;
    the padding tiles are the last group's past n_tiles and write nothing;
    the blocks of a cluster take as many tiles each (the same slabs, in
    lockstep), each its real tiles first; the bias-partial rows and the
    workspace blocks stay one per 64-row half per tile, 2 n_tiles of each
    in all, whichever block takes it."""
    groups = -(-n_tiles // cluster)
    for active in (1, 3, 132 // cluster):
        blocks = P.cluster_blocks(n_tiles, cluster, active)
        n_clusters = blocks // cluster
        assert blocks % cluster == 0 and n_clusters == min(active, groups)
        walk = P.cluster_walk(n_tiles, cluster, n_clusters)
        assert len(walk) == blocks
        taken = sorted(t for w in walk for t in w)
        assert taken == list(range(groups * cluster))
        pads = taken[n_tiles:]
        assert all(P.tile_writes(t, n_tiles) == dict(
            part_rows=[], ws_blocks=[], rows=range(0)) for t in pads)
        for b, w in enumerate(walk):
            k, r = divmod(b, cluster)
            assert len(w) == len(walk[k * cluster])
            real = [t < n_tiles for t in w]
            assert real == sorted(real, reverse=True)
            assert w == [g * cluster + r for g in range(k, groups,
                                                         n_clusters)]
        rows = [pr for w in walk for t in w
                for pr in P.tile_writes(t, n_tiles)["part_rows"]]
        assert sorted(rows) == list(range(2 * n_tiles))
        blocks_ws = [b for w in walk for t in w
                     for b in P.tile_writes(t, n_tiles)["ws_blocks"]]
        assert sorted(blocks_ws) == list(range(2 * n_tiles))


@pytest.mark.parametrize("case", list(STREAM_NETS))
def test_stream_backward_layout_holds_its_barriers(case):
    """Each stream net's backward layout (``stream_smem``, the C
    ``bwd_layout``'s mirror): up to 256 wide two warpgroup regions and the
    column sums before a cluster ring (three barrier arrays: full, empty,
    peer) of 64-row slabs where ``MIN_BWD_STAGES`` of them fit, else 32-row
    ones (16 where too few of those fit); when wide one region and at
    least two stages; over half and within a block's shared memory either
    way, so that a block holds an SM and a cluster of two takes two."""
    cols, F, widths, _, _ = STREAM_NETS[case]
    din = cols * (1 + 2 * F) if F is not None else cols
    plan = mp.build_stream_plan(din, widths, cols if F is not None else 0,
                                F or 0, backward=True)
    h = plan.header
    wide = mp.stream_wide(h)
    total, stages = mp.stream_smem(h, True)
    in_b = P.al128(mp.ROWS * h[mp.M_IN_PAD] * 2)
    region = (max(in_b, P.al128(mp.ROWS * h[mp.M_IN_PAD] * 4))
              if h[mp.M_DIM] else in_b)
    act = P.al128(mp.ROWS * h[mp.M_ACT_W] * 2)
    off = (1 if wide else 2) * (region + act) + 2 * 4 * P.MAX_N * 4
    width = mp.MAX_W if wide else P.MAX_N
    least = 2 if wide else mp.MIN_BWD_STAGES
    slab = (64 if P.ring_stages(off, 64, width, 3)[0] >= mp.MIN_BWD_STAGES
            else 32 if P.ring_stages(off, 32, width, 3)[0] >= least else 16)
    assert (stages, total) == P.ring_stages(off, slab, width, 3)
    if not wide and F is not None and cols * (1 + 2 * F) <= 64:
        assert slab == 64, (case, slab)       # [prop256]'s nets and the like
    assert P.CLUSTER_BAR_SETS == 3
    assert stages >= (2 if wide else mp.MIN_BWD_STAGES)
    assert tmlp.MAX_SMEM_BYTES // 2 < total <= tmlp.MAX_SMEM_BYTES



def _stream_split_model(x, wbs, F=None):
    """The stream forward's wide program as its cluster runs it, in
    float32: two blocks, each warpgroup with one buffer that takes the
    input (K5's encoding or K3's x) and every layer in place, each block
    computing its half of every product's columns from the half slabs its
    producer copies (``pe_plan.half_slab_index``) and writing that half
    into its own buffer and its peer's; the last layer's columns come from
    the block that owns them.  The two copies must stay equal."""
    din, widths = wbs[0].shape[0], [w.shape[1] for w in wbs[0::2]]
    dim = x.shape[1] if F is not None else 0
    key = mp.program_key(din, widths, dim, F or 0, False)
    plan = mp.stream_plan(key)
    h = plan.header
    assert mp.stream_wide(h)
    img, bias = _images(wbs, key, torch.float32)
    N = x.shape[0]
    n_pad = -(-N // P.TILE) * P.TILE
    xs = torch.zeros((n_pad, x.shape[1]))
    xs[:N] = x
    width = max(h[mp.M_IN_PAD], h[mp.M_ACT_W])
    blocks = [torch.zeros((n_pad, width)) for _ in range(P.CLUSTER)]
    for buf in blocks:                         # each block encodes the rows
        buf[:, :din] = tfield._encode(xs, F) if dim else xs
    out = torch.full((n_pad, h[mp.M_DOUT]), float("nan"))
    for op in plan.ops:
        n, K, half = op[P.O_N], op[P.O_K], op[P.O_N] // 2
        accs = []
        for rank, buf in enumerate(blocks):
            b = torch.cat([P.from_core_k_major(img[torch.tensor(idx)],
                                               len(idx) // half, half)
                           for idx in P.half_slab_index(op, rank)])
            acc = buf[:, :K] @ b
            c = torch.arange(rank * half, (rank + 1) * half)
            live = c < op[P.O_NVALID]
            acc[:, live] += bias[op[P.O_BOFF] + c[live]]
            accs.append(acc)
        for rank, acc in enumerate(accs):
            if op[P.O_EPI] == mp.Y_OUT:
                w = max(0, min(half, h[mp.M_DOUT] - rank * half))
                out[:, rank * half:rank * half + w] = acc[:, :w]
                continue
            for buf in blocks:                 # its own copy and its peer's
                buf[:, rank * half:(rank + 1) * half] = torch.relu(acc)
    assert torch.equal(blocks[0], blocks[1])
    return out[:N]


# [w512]'s wide stream forwards: K5's first proposal net (3 x 512, F = 5)
# and K3's semantic head ([15, 512, 1]), and a K3 net whose 512-wide input
# is wider than its layers
SPLIT_NETS = {"w512-net0": (3, 5, [512, 512, 1]),
              "w512-semantic-head": (15, None, [512, 1]),
              "wide-input": (512, None, [256, 16])}


@pytest.mark.parametrize("case", list(SPLIT_NETS))
def test_stream_split_model_reproduces_plain(case):
    """The wide stream forward's column split (``_stream_split_model``)
    gives the float32 plain version's output to 1e-5 of its largest
    value; its layout (``stream_smem``) is a 512-wide buffer a warpgroup,
    the handshake barriers and six 16 KB stages, within a block's shared
    memory."""
    cols, F, widths = SPLIT_NETS[case]
    rng = np.random.default_rng(5)
    din = cols * (1 + 2 * F) if F is not None else cols
    x = torch.from_numpy(rng.uniform(-1, 1, (200, cols)).astype(np.float32))
    wbs = to_torch(np_wbs(rng, [din] + widths))
    got = _stream_split_model(x, wbs, F)
    ref = (tfield.fused_pe_mlp_plain(x, wbs, F, torch.float32) if F is not None
           else tmlp.fused_mlp_plain(x, wbs, torch.float32))
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
    h = mp.stream_plan(mp.program_key(din, widths, cols if F is not None else 0,
                                      F or 0, False)).header
    assert mp.stream_smem(h, False) == (229_632, 6)

@pytest.mark.parametrize("net", [(15, [513, 1]), (513, [8, 1]),
                                 (15, [64] * 33), (15, [600])])
def test_stream_route_refuses_wider_nets(net):
    """Nets over 512 wide, a din over 512 or more than 32 layers take no
    kernel: fused_mlp_route raises, and so does the plan."""
    din, widths = net
    assert not mp.stream_takes(din, widths)
    with pytest.raises(ValueError):
        tmlp.fused_mlp_route(din, widths)
    with pytest.raises(ValueError):
        mp.build_stream_plan(din, widths)


def test_stream_images_lay_out_each_products_operand():
    """The weight image holds each product's B in program order: a
    forward op's W_l [k, n] zero-padded to [k rounded to 16, its wgmma
    width], a backward op's W_lᵀ over the input rows it produces, zero
    elsewhere; the biases padded to 16 layer after layer."""
    wt = to_torch(np_wbs(np.random.default_rng(3), [39, 100, 256, 3]))
    key = mp.program_key(39, [100, 256, 3], 3, 6, True)
    plan = mp.stream_plan(key)
    img, bias = mp.stream_images(wt, key)
    assert img.dtype == torch.bfloat16 and img.numel() == plan.header[
        mp.M_IMG_ELEMS]
    for op, (layer, transposed, row0, rows, K, N) in zip(
            [o for o in plan.ops if o[P.O_KIND] != P.EMIT], plan.images):
        b = P.from_core_k_major(img[op[P.O_IMG]:op[P.O_IMG] + K * N], K, N)
        w = wt[2 * layer].bfloat16()
        want = torch.zeros((K, N), dtype=torch.bfloat16)
        if transposed:
            part = w[row0:row0 + rows].T
            want[:part.shape[0], :part.shape[1]] = part
        else:
            want[:w.shape[0], :w.shape[1]] = w
        assert torch.equal(b, want), (layer, transposed, row0)
    want_b = torch.cat([torch.nn.functional.pad(
        wt[2 * l + 1].reshape(-1), (0, -(-n // 16) * 16 - n))
        for l, n in enumerate([100, 256, 3])])
    assert torch.equal(bias, want_b)


# --- the slice: cropnerf-mxu-q with both proposal nets fused at 256 wide --

def prop256(presets, **changes):
    """``[prop256]``, reduced: ``cropnerf-mxu-q`` with both PE proposal nets
    fused and 256 wide (``benchmarks/ab_propshape.py``'s
    ``dataclasses.replace``), 3 layers each, with few rays and samples
    (``test_torch_propfused.propfused``)."""
    from test_torch_propfused import propfused
    cfg = propfused(presets, "cropnerf-mxu-q", **changes)
    m = cfg.model
    m = dataclasses.replace(m, proposal_fields=tuple(
        dataclasses.replace(p, hidden_dim=256) for p in m.proposal_fields))
    return dataclasses.replace(cfg, model=m)


@pytest.mark.parametrize("arm", ["f32"], indirect=True)
def test_prop256_train_step_matches_jax(arm, monkeypatch):
    """One training step of [prop256] against JAX's (its proposal nets on
    the stream route's forward and backward on the card), in the float32
    arm, every leaf behind a relu unit and the rays in relative L2 to
    Q_KINK_TOL, as cropnerf-mxu-q's step (test_torch_propfused_wide.py)."""
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from test_torch_propfused_wide import Q_KINK_TOL, _q_kinked
    from test_torch_train import RAYS, STEP, check_train_step
    jcfg, tcfg = (prop256(p, train_num_rays_per_batch=RAYS)
                  for p in (JAX_PRESETS, TORCH_PRESETS))
    for p in tcfg.model.proposal_fields:
        assert (p.hidden_dim, p.num_layers, p.mlp_impl) == (
            256, 3, "pallas-fused")
        widths = [256] * (p.num_layers - 1) + [1]
        assert tfield.pe_mlp_fwd_route(3, p.pe_freqs, widths) == "stream"
    check_train_step(jcfg, tcfg, STEP, arm, monkeypatch, _q_kinked,
                     Q_KINK_TOL)


# --- the slice: cropnerf-mxu with a 512-wide trunk, semantic head and PE
# proposal nets ([w512]) --

def w512(presets, **changes):
    """``[w512]``, reduced: ``cropnerf-mxu`` with a 512-wide trunk
    (``field.hidden_dim``) and semantic head (``hidden_dim_semantics``),
    and both PE proposal nets fused and 512 wide, 3 layers each
    (``dataclasses.replace``, as ``benchmarks/ab_propshape.py`` builds its
    arms), with few rays and samples (``test_torch_propfused.propfused``);
    the colour head stays 64 wide."""
    from test_torch_propfused import propfused
    cfg = propfused(presets, "cropnerf-mxu", **changes)
    m = cfg.model
    m = dataclasses.replace(
        m, field=dataclasses.replace(m.field, hidden_dim=512,
                                     hidden_dim_semantics=512),
        proposal_fields=tuple(dataclasses.replace(p, hidden_dim=512)
                              for p in m.proposal_fields))
    return dataclasses.replace(cfg, model=m)


@pytest.mark.parametrize("arm", ["f32"], indirect=True)
def test_w512_train_step_matches_jax(arm, monkeypatch):
    """One training step of [w512] against JAX's (on the card: K1 forward
    and backward as wide programs with the 512-wide semantic head inside,
    both proposal nets on the stream route's wide programs), in the float32
    arm, every leaf behind a relu unit and the rays in relative L2 to
    Q_KINK_TOL, as cropnerf-mxu-q's and [prop256]'s steps."""
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from cropnerf_tpu_torch.models.vanilla import fused_field_weights
    from cropnerf_tpu_torch.models.vanilla import vanilla_field_init
    from test_torch_propfused_wide import Q_KINK_TOL, _q_kinked
    from test_torch_train import RAYS, STEP, check_train_step
    jcfg, tcfg = (w512(p, train_num_rays_per_batch=RAYS)
                  for p in (JAX_PRESETS, TORCH_PRESETS))
    f = tcfg.model.field
    assert (f.hidden_dim, f.hidden_dim_semantics, f.hidden_dim_color,
            f.mlp_impl) == (512, 512, 64, "pallas-fused")
    field = vanilla_field_init(f, 2, torch.Generator().manual_seed(0))
    _, _, meta = tfield.pack_pe_field(3, 10, *fused_field_weights(field, f),
                                      de=27 + f.appearance_embedding_dim)
    assert P.width_class([P.build_plan(meta, True, False, True).header[
        P.H_ACT_W]]) == 1
    for p in tcfg.model.proposal_fields:
        assert (p.hidden_dim, p.num_layers, p.mlp_impl) == (
            512, 3, "pallas-fused")
        widths = [512] * (p.num_layers - 1) + [1]
        assert tfield.pe_mlp_fwd_route(3, p.pe_freqs, widths) == "stream"
    assert tmlp.fused_mlp_route(f.geo_feat_dim, [512, 1]) == "stream"
    check_train_step(jcfg, tcfg, STEP, arm, monkeypatch, _q_kinked,
                     Q_KINK_TOL)
