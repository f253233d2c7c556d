"""The programs of the PE field's tile kernels: the forward
(``csrc/fused_pe_field.cu``) and the recompute backward
(``csrc/fused_pe_field_bwd.cu``), which share their interpreter
(``csrc/pe_tile.cuh``).

Each kernel interprets a list of ops that this module builds from the
forward's meta (``pack_pe_field``).  The forward program runs the layers
in order and writes t, rgb_raw and sem_raw; the backward's runs the
forward recompute layer by layer, then the backward through the heads and
the trunk.  Each product op names its operands, its output width N (16,
32, 64, 128, 256, 512 or 1024), its reduction width K and the
offset of its B operand in the weight image; each op names its epilogue.
For the backward the same module lays out the workspace that the
weight-gradient pass reads and lists that pass's tasks.

A program's width class (``width_class``) is that of its widest layer.  A
program whose layers are all at most ``MAX_N`` (256) wide (class 0) runs
each product as one ``wgmma`` shape on a warpgroup's own 64 rows.  A
program with a wider layer (up to ``PASS_W``, 512: class 1, "wide") splits
every product's N columns in halves, so that no accumulator is wider than
256.  The forward runs as persistent clusters of ``CLUSTER`` (2)
blocks that walk the 128-row tiles together, each block computing one
half of every product from that half of each slab alone
(``half_slab_index``) and mirroring its output into the other block's
tiles (``fwd_smem`` mirrors its layout); the backward keeps both
warpgroups of a block on one 64-row tile, each taking half of every
product: its relu masks take half the words a thread, its input-gradient
products take chunks up to 512 wide, and its weight-gradient tasks take a
G slot wider than 256 in 256-column blocks (``T_J0``).  A program with a
layer over 512 (up to ``MAX_W``, 1024: class 2) keeps both warpgroups on
one 64-row tile in the forward too; a product over 512 takes two passes of
both warpgroups, 256 columns a warpgroup a pass, its B in the weight image
as one ``PASS_W``-wide image a pass (``pass_columns``), the first pass's
output held until the second has read the tile (the backward's in
registers, the forward's in a block's scratch in device memory,
``fwd_park_elems``); the backward's relu masks go to device memory; the
output layers (t, rgb, sem) stay at most 512 wide.
Everything here is plain Python, so the CPU tests run both programs
(``tests/test_torch_kernels.py``) and hold them against the plain versions
and autograd.

Layouts, shared with the kernels:

* a block of 64 rows of an activation of width w is "chunk-major": element
  (r, c) at (c // 8) * 512 + r * 8 + c % 8, so that every 8x8 bf16 core
  matrix of ``wgmma`` is 128 contiguous bytes;
* the weight image holds, for each product op in program order, its B
  matrix [K, N] in the K-major core-matrix layout: element (k, j) at
  ((k // 8) * (N // 8) + j // 8) * 64 + (j % 8) * 8 + k % 8 (a class 2
  product over 512 wide: one such image of [K, 512] a pass, the pass's
  columns ``pass_columns`` in order);
* the workspace holds slots (an activation A_l or a cotangent G_l), each
  ``width`` columns wide starting at column ``col`` of a row: element
  (R, c) of the slot at col * n_pad + (R // 64) * 64 * width + the
  chunk-major offset of (R % 64, c).  A slot's 64-row block is one
  contiguous range, written by one bulk store and read by one bulk load.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from .common import MAX_SMEM_BYTES

TILE = 128               # rows per tile (two warpgroups of 64)
BLOCK = 64               # rows per warpgroup and per workspace block
DW_M = 128               # weight rows per weight-gradient task (2 x 64)
MAX_N = 256              # the widest product a warpgroup takes (one wgmma)
PASS_W = 512             # two warpgroups' halves: the widest layer of class 1,
                         # a pass of class 2
MAX_W = 1024             # the widest layer: two passes
SPLIT_TARGET = 264       # weight-gradient blocks to aim for (2 per SM)

# header of the program
(H_DIM, H_FREQS, H_ENC_COLS, H_ENC_PAD, H_DE, H_EX_PAD, H_T_COLS, H_RGB_COLS,
 H_SEM_COLS, H_ACT_W, H_TB_W, H_MASK_WORDS, H_WS_COLS, H_ENC_SLOT, H_N_OPS,
 H_N_TASKS, H_TOTAL_W, H_TOTAL_B, H_IMG_ELEMS, H_STORE, H_HEADER) = range(21)

# op fields
(O_KIND, O_N, O_K, O_A0, O_A1, O_KA, O_IMG, O_EPI, O_BOFF, O_NVALID, O_MASK,
 O_WS, O_COL, OP_INTS) = range(14)
# op kinds
FWD, EX, EMIT, BWD = range(4)
# shared-memory buffers of a warpgroup
ACT, ENC, TB = range(3)
# epilogues: FWD ops (the *_OUT ones write float32 rows to the outputs; T_OUT
# also keeps t's bf16 copy in TB for the heads)
RELU, LINEAR, T_OUT, RGB_OUT, SEM_OUT = range(5)
# epilogues: BWD ops (G_MASKED writes the cotangent in place)
G_MASKED, GT_ADD, DEX, GENC_SET, GENC_ADD = range(5)
# EMIT sources
SRC_GT, SRC_RGB, SRC_SEM = range(3)

# weight-gradient task fields: A's slot, width and first column; the
# weight rows; G's slot, the task's G columns (a wgmma width), the layer's
# padded width (dW's row stride), dW's offset; G's slot width and the
# task's first G column (0 unless G is wider than MAX_N)
(T_A_COL, T_A_W, T_I0, T_M_VALID, T_W_ROW0, T_G_COL, T_BN, T_N, T_W_OFF,
 T_G_W, T_J0, TASK_INTS) = range(12)


def pow2_width(n: int) -> int:
    """The smallest product width (16 · 2^i) that holds n columns, up to
    ``MAX_W``."""
    w = 16
    while w < n:
        w *= 2
    if w > MAX_W:
        raise ValueError(f"width {n} exceeds {MAX_W}")
    return w


def pow2_chunks(n: int, largest: int = MAX_N) -> List[int]:
    """n (a multiple of 16) as a sum of product widths up to ``largest``,
    largest first."""
    out, rest = [], n
    for w in (1024, 512, 256, 128, 64, 32, 16):
        while w <= largest and rest >= w:
            out.append(w)
            rest -= w
    return out


def width_class(widths) -> int:
    """The width class of a program whose products and activation tiles
    have these widths (the kernels: of the header's activation width).  0
    up to MAX_N: a warpgroup a product.  1 up to PASS_W ("wide"): every
    product's columns in halves, the forward's over a cluster of two
    blocks, the backward's between a block's two warpgroups on one 64-row
    tile.  2 up to MAX_W: both warpgroups on one 64-row tile forward and
    backward, a product over PASS_W in two passes."""
    w = max(widths)
    return 2 if w > PASS_W else 1 if w > MAX_N else 0


def mask_words(n: int, wide: int) -> int:
    """Relu-mask words a thread keeps for a product n wide: 4 bits for
    each 8 columns of its accumulator (half of them when wide, class 1 or
    2; a class 2 pass's 256 columns take 4 words)."""
    return ((n // 2 if wide else n) + 63) // 64


def pass_columns(n: int) -> List[List[int]]:
    """The columns of a product n wide (over PASS_W, class 2) that each
    pass computes, in the order its image holds them: warpgroup w's 256
    columns [w n/2 + 256 q, +256) of pass q, warpgroup 0's first."""
    half, step = n // 2, PASS_W // 2
    return [[w * half + q * step + j for w in range(2) for j in range(step)]
            for q in range(n // PASS_W)]


def dw_tasks(a_col, a_w, rows, w_row0, g_col, g_w, n, w_off):
    """The weight-gradient tasks of dW rows [w_row0, w_row0 + rows)
    (A's first ``rows`` columns in slot (a_col, a_w)) against the G slot
    (g_col, g_w) of a layer n wide: DW_M weight rows a task, G in blocks of
    at most MAX_N columns."""
    tasks = []
    for i0 in range(0, rows, DW_M):
        for j0 in range(0, n if g_w > MAX_N else 1, MAX_N):
            t = [0] * TASK_INTS
            t[T_A_COL], t[T_A_W], t[T_I0] = a_col, a_w, i0
            t[T_M_VALID] = min(DW_M, rows - i0)
            t[T_W_ROW0] = w_row0 + i0
            t[T_G_COL], t[T_BN], t[T_N] = g_col, min(g_w, MAX_N), n
            t[T_W_OFF], t[T_G_W], t[T_J0] = w_off, g_w, j0
            tasks.append(t)
    return tasks


@dataclasses.dataclass
class Plan:
    header: List[int]
    ops: List[List[int]]
    tasks: List[List[int]]
    # per product op, in order: (layer, transposed, row0, rows, K, N) of
    # the B matrix it reads (see image_index)
    images: List[tuple]
    slots: dict              # name -> (col, width)

    def ints(self) -> List[int]:
        return (self.header + [v for op in self.ops for v in op]
                + [v for t in self.tasks for v in t])


class _Net:
    """The layers of ``meta`` as the programs see them, checked, and the
    op list being built."""

    def __init__(self, meta, heads: bool):
        (self.dim, self.F, self.enc_cols, self.enc_pad, de, ex_pad, n_base,
         n_top, n_color, n_sem, self.t_cols, rgb_cols, sem_cols, _) = meta[:14]
        L = [list(meta[14 + 5 * i:19 + 5 * i])
             for i in range((len(meta) - 14) // 5)]
        if not heads:
            n_color = n_sem = 0
            L = L[:n_base + n_top]
        self.heads, self.L = heads, L
        self.de, self.ex_pad = (de, ex_pad) if heads else (0, 0)
        self.rgb_cols, self.sem_cols = ((rgb_cols, sem_cols) if heads
                                        else (0, 0))
        self.n_base, self.n_color, self.n_sem = n_base, n_color, n_sem
        self.top0, self.c0 = n_base, n_base + n_top
        self.s0 = self.c0 + n_color
        self.n_layers = len(L)
        self.nw = [pow2_width(l[3]) for l in L]
        self.wide = width_class(self.nw + [self.ex_pad])
        self.t_last = self.c0 - 1
        outputs = [self.t_last] + ([self.s0 - 1, len(L) - 1] if heads else [])
        wide_out = [l for l in outputs if self.nw[l] > PASS_W]
        if wide_out:
            raise ValueError(f"an output layer of {L[wide_out[0]][3]} padded "
                             f"columns; the kernels' output layers take at "
                             f"most {PASS_W}")
        if L[0][2] != self.enc_pad or L[self.top0][2] - L[self.top0][4] != self.enc_pad:
            raise ValueError("the encoding must feed layer 0 and the skip layer")
        if heads and (L[self.c0][4] != L[self.t_last][3]
                      or L[self.c0][2] != L[self.t_last][3] + ex_pad
                      or L[self.s0][2] != L[self.t_last][3]):
            raise ValueError("head layer 0 must take the padded trunk output")
        self.ops, self.images, self.img = [], [], 0

    _FIELDS = dict(a0=O_A0, a1=O_A1, ka=O_KA, epi=O_EPI, boff=O_BOFF,
                   nvalid=O_NVALID, mask=O_MASK, ws=O_WS, col=O_COL)

    def other(self, kind, N, **f):
        op = [0] * OP_INTS
        op[O_KIND], op[O_N] = kind, N
        op[O_BOFF] = op[O_MASK] = op[O_WS] = -1
        for k, v in f.items():
            op[self._FIELDS[k]] = v
        self.ops.append(op)
        return op

    def product(self, kind, layer, transposed, row0, rows, K, N, **f):
        op = self.other(kind, N, **f)
        op[O_K], op[O_IMG] = K, self.img
        self.images.append((layer, transposed, row0, rows, K, N))
        self.img += K * N

    def fwd(self, l, a0, a1=None, **f):
        """A forward product op of layer l on [a0 | a1] (a0 alone if a1 is
        None), bias and epilogue fields in ``f``."""
        w_off, b_off, k, n, ka = self.L[l]
        self.product(FWD, l, False, 0, k, k, self.nw[l], a0=a0,
                     a1=a0 if a1 is None else a1,
                     ka=ka if a1 is not None else k, boff=b_off, nvalid=n,
                     **f)

    def header(self, fields: dict) -> List[int]:
        """The program's header; ``fields`` maps header indices to values."""
        act_w = max(self.nw + [self.ex_pad])
        ln = self.L[-1]
        h = [0] * H_HEADER
        h[H_DIM], h[H_FREQS] = self.dim, self.F
        h[H_ENC_COLS], h[H_ENC_PAD] = self.enc_cols, self.enc_pad
        h[H_DE], h[H_EX_PAD] = self.de, self.ex_pad
        h[H_T_COLS], h[H_RGB_COLS], h[H_SEM_COLS] = (
            self.t_cols, self.rgb_cols, self.sem_cols)
        h[H_ACT_W], h[H_TB_W] = act_w, self.nw[self.t_last]
        h[H_N_OPS] = len(self.ops)
        h[H_TOTAL_W] = ln[0] + ln[2] * ln[3]
        h[H_TOTAL_B] = ln[1] + ln[3]
        h[H_IMG_ELEMS] = self.img
        for k, v in fields.items():
            h[k] = v
        return h


def build_forward_plan(meta, heads: bool) -> Plan:
    """The forward kernel's program for the packed layout ``meta``: one FWD
    op per layer in order (the heads' output layers included), the EX op
    that brings the extras in before the colour head, and the output
    epilogues: T_OUT on the trunk's last layer, RGB_OUT and SEM_OUT on the
    heads' last layers.  ``heads`` False plans the trunk alone
    (fused_pe_density).  No masks, workspace or tasks."""
    net = _Net(meta, heads)
    last = net.n_layers - 1
    for l in range(net.n_base):
        net.fwd(l, ENC if l == 0 else ACT, epi=RELU)
    for l in range(net.top0, net.c0):
        net.fwd(l, ACT, ENC if l == net.top0 else None,
                epi=T_OUT if l == net.t_last else RELU)
    if heads:
        net.other(EX, net.ex_pad)
        for l in range(net.c0, net.s0):
            net.fwd(l, TB if l == net.c0 else ACT, ACT if l == net.c0 else None,
                    epi=RGB_OUT if l == net.s0 - 1 else RELU)
        for l in range(net.s0, net.n_layers):
            net.fwd(l, TB if l == net.s0 else ACT,
                    epi=SEM_OUT if l == last else RELU)
    return Plan(net.header({H_ENC_SLOT: -1}), net.ops, [], net.images, {})


def build_plan(meta, heads: bool, pass_sem: bool, need_dw: bool) -> Plan:
    """The backward's tile program, workspace slots and weight-gradient
    tasks for the packed layout ``meta`` (``pack_pe_field``).  ``heads``
    False plans the trunk alone (the backward of fused_pe_density);
    ``need_dw`` False plans dx alone (no workspace, no bias sums)."""
    if heads and not need_dw:
        raise ValueError("the backward with the heads always computes dW")
    net = _Net(meta, heads)
    L, nw, n_base, n_layers = net.L, net.nw, net.n_base, net.n_layers
    top0, c0, s0, t_last = net.top0, net.c0, net.s0, net.t_last
    n_color, n_sem = net.n_color, net.n_sem

    # the layers whose output passes a relu (and so has a mask)
    hidden = (list(range(n_base)) + list(range(top0, t_last))
              + list(range(c0, c0 + n_color - 1)) + list(range(s0, n_layers - 1)))
    masks, words = {}, 0
    for l in hidden:
        masks[l] = words
        words += mask_words(nw[l], net.wide)

    slots, ws_cols = {}, 0

    def slot(name, width):
        nonlocal ws_cols
        if need_dw:
            slots[name] = (ws_cols, width)
            ws_cols += width
        return slots[name][0] if need_dw else -1

    enc_slot = slot("enc", net.enc_pad)

    # ---- forward recompute
    def fwd(l, a0, a1=None):
        net.fwd(l, a0, a1, epi=LINEAR if l == t_last else RELU,
                mask=masks.get(l, -1), ws=slot(f"a{l}", nw[l]))

    for l in range(n_base):
        fwd(l, ENC if l == 0 else ACT)
    for l in range(top0, c0):
        fwd(l, ACT, ENC if l == top0 else None)
    if heads:
        net.other(EX, net.ex_pad, ws=slot("ex", net.ex_pad))
        for l in range(c0, c0 + n_color - 1):
            fwd(l, TB if l == c0 else ACT, ACT if l == c0 else None)
        for l in range(s0, n_layers - 1):
            fwd(l, TB if l == s0 else ACT)

    # ---- backward
    def emit(l, src):
        net.other(EMIT, nw[l], epi=src, boff=L[l][1] if need_dw else -1,
                  nvalid=L[l][3], ws=slot(f"g{l}", nw[l]))

    def grad_g(l):
        """G_{l-1} = mask ⊙ (G_l · W_lᵀ), in place (the skip layer's h part)."""
        p = l - 1 if l != top0 else n_base - 1
        n_in = L[l][4] if l == top0 else L[l][2]
        net.product(BWD, l, True, 0, n_in, L[l][3], nw[p], a0=ACT, a1=ACT,
                    ka=L[l][3], epi=G_MASKED, boff=L[p][1] if need_dw else -1,
                    nvalid=L[p][3], mask=masks[p], ws=slot(f"g{p}", nw[p]))

    def grad_to(l, c_lo, cw, epi):
        col = 0
        for N in pow2_chunks(cw, PASS_W if net.wide else MAX_N):
            net.product(BWD, l, True, c_lo + col, N, L[l][3], N, a0=ACT,
                        a1=ACT, ka=L[l][3], epi=epi, col=col)
            col += N

    if heads:
        for first, count, src in ((c0, n_color, SRC_RGB), (s0, n_sem, SRC_SEM)):
            last = first + count - 1
            emit(last, src)
            for l in range(last, first, -1):
                grad_g(l)
            ka, k = L[first][4], L[first][2]
            if first == c0:
                grad_to(first, 0, ka, GT_ADD)
                grad_to(first, ka, k - ka, DEX)
            elif pass_sem:
                grad_to(first, 0, k, GT_ADD)
    emit(t_last, SRC_GT)
    for l in range(t_last, top0, -1):
        grad_g(l)
    ka, k = L[top0][4], L[top0][2]
    grad_to(top0, ka, k - ka, GENC_SET)
    grad_g(top0)
    for l in range(n_base - 1, 0, -1):
        grad_g(l)
    grad_to(0, 0, L[0][2], GENC_ADD)

    # ---- weight-gradient tasks: dW_l = A_lᵀ · G_l over the rows
    tasks = []
    if need_dw:
        def a_parts(l):
            k, ka = L[l][2], L[l][4]
            if l == 0:
                return [("enc", 0, k)]
            if l == top0:
                return [(f"a{n_base - 1}", 0, ka), ("enc", ka, k - ka)]
            if heads and l == c0:
                return [(f"a{t_last}", 0, ka), ("ex", ka, k - ka)]
            if heads and l == s0:
                return [(f"a{t_last}", 0, k)]
            return [(f"a{l - 1}", 0, k)]

        for l in range(n_layers):
            g_col, g_w = slots[f"g{l}"]
            for name, row0, rows in a_parts(l):
                a_col, a_w = slots[name]
                tasks += dw_tasks(a_col, a_w, rows, row0, g_col, g_w,
                                  L[l][3], L[l][0])

    header = net.header({H_MASK_WORDS: words, H_WS_COLS: ws_cols,
                         H_ENC_SLOT: enc_slot, H_N_TASKS: len(tasks),
                         H_STORE: int(need_dw)})
    return Plan(header, net.ops, tasks, net.images, slots)


def image_index(meta, plan: Plan) -> torch.Tensor:
    """Where each element of the weight image comes from: an index into the
    packed bf16 weights (``pack_pe_field``), -1 for a zero.  Each product
    op's B [K, N] in the K-major core-matrix layout, in program order (a
    product over PASS_W: each pass's columns, ``pass_image``): a forward
    op's B is W_l's [k, n] block (zero columns up to N); a backward op's is
    Wᵀ restricted to the input rows it produces (zero rows up to N)."""
    L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
    parts = []
    for layer, transposed, row0, rows, K, N in plan.images:
        w_off, _, k, n, _ = L[layer]
        idx = torch.full((K, N), -1, dtype=torch.int64)
        cols = torch.arange(n)
        if transposed:
            idx[:n, :rows] = w_off + (row0 + torch.arange(rows))[None, :] * n + cols[:, None]
        else:
            idx[:, :n] = w_off + torch.arange(k)[:, None] * n + cols[None, :]
        parts.append(pass_image(idx))
    return torch.cat(parts)


def pass_image(b: torch.Tensor) -> torch.Tensor:
    """A product's B [K, N] → its weight image: the K-major core-matrix
    image, or over PASS_W that of each pass's columns in turn."""
    if b.shape[1] <= PASS_W:
        return core_k_major(b)
    return torch.cat([core_k_major(b[:, cols]) for cols in pass_columns(b.shape[1])])


def from_pass_image(img: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of :func:`pass_image`."""
    if N <= PASS_W:
        return from_core_k_major(img, K, N)
    b = torch.empty((K, N), dtype=img.dtype)
    for q, cols in enumerate(pass_columns(N)):
        b[:, cols] = from_core_k_major(img[q * K * PASS_W:(q + 1) * K * PASS_W], K, PASS_W)
    return b


def weight_image(wbuf: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The bf16 weight image the tile kernel streams, gathered from the
    packed weights by :func:`image_index` (its -1 takes an appended zero)."""
    return torch.cat([wbuf, wbuf.new_zeros(1)])[index]


def core_k_major(b: torch.Tensor) -> torch.Tensor:
    """B [K, N] → its K-major core-matrix image (flat)."""
    K, N = b.shape
    return b.reshape(K // 8, 8, N // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def from_core_k_major(img: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of :func:`core_k_major`."""
    return img.reshape(K // 8, N // 8, 8, 8).permute(0, 3, 1, 2).reshape(K, N)


def ws_elems(plan: Plan, n_rows: int) -> int:
    """bf16 elements of the workspace at n_rows rows, with the tail the
    weight-gradient pass may read past the last slot (one task's A block)."""
    if not plan.header[H_STORE]:
        return 0
    n_pad = -(-n_rows // TILE) * TILE
    return plan.header[H_WS_COLS] * n_pad + BLOCK * DW_M


def ws_index(col: int, width: int, n_pad: int, rows: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    """Workspace element index of (row, column) of the slot (col, width)."""
    r, c = rows[:, None], cols[None, :]
    return (col * n_pad + (r // BLOCK) * BLOCK * width + (c // 8) * 512
            + (r % BLOCK) * 8 + c % 8)


def dw_splits(n_rows: int, n_tasks: int) -> int:
    """Row splits of the weight-gradient pass: about SPLIT_TARGET blocks in
    all, each split a whole number of 64-row blocks."""
    blocks = -(-n_rows // TILE) * (TILE // BLOCK)
    want = max(1, -(-SPLIT_TARGET // max(n_tasks, 1)))
    per = max(1, -(-blocks // want))
    return -(-blocks // per), per


# ---- the persistent clusters (csrc/pe_tile.cuh) -----------------------------

CLUSTER_BAR_SETS = 3     # a cluster ring's barrier arrays: full, empty, peer
RING_STAGES, SLAB_K = 8, 32   # ring stages at most, the backward's slab rows
CLUSTER = 2              # a cluster's blocks: a wide forward's halves of a product
MIRROR_BYTES = 32        # a wide forward block's handshake barriers (Mirror)
FWD_SLAB, FWD_MIN_STAGES = 64, 3   # the forward's slab rows and least stages
PASS_MIN_STAGES = 2      # class 2's forward: one wgmma group in flight
PARK_WORDS = MAX_N // 4  # class 2's forward: the bf16 pairs a thread parks a pass


def cluster_walk(n_tiles: int, cluster: int, n_clusters: int
                 ) -> List[List[int]]:
    """``ClusterWalk``: the tiles each block of a persistent grid of
    ``n_clusters`` clusters of ``cluster`` blocks takes, in order (block
    ``cluster * k + r`` is rank r of cluster k).  The cluster takes groups
    of ``cluster`` consecutive tiles, from its index in steps of
    ``n_clusters``; its rank-r block tile ``cluster * group + r`` of each.
    A tile from ``n_tiles`` on is a padding tile: its block takes the
    slabs and writes nothing."""
    groups = -(-n_tiles // cluster)
    return [[g * cluster + r for g in range(k, groups, n_clusters)]
            for k in range(n_clusters) for r in range(cluster)]


def cluster_blocks(n_tiles: int, cluster: int, active: int) -> int:
    """``cluster_launch``'s grid: ``active`` clusters resident at once,
    at most one a group of tiles."""
    return min(active, -(-n_tiles // cluster)) * cluster


def tile_writes(tile: int, n_tiles: int) -> dict:
    """What a backward tile kernel writes for ``tile``: its two 64-row
    halves' bias-partial rows (``part_row``), workspace blocks (a slot's
    64-row block ``row0 / 64``) and the rows of dx; nothing for a padding
    tile."""
    if tile >= n_tiles:
        return dict(part_rows=[], ws_blocks=[], rows=range(0))
    return dict(part_rows=[2 * tile, 2 * tile + 1],
                ws_blocks=[2 * tile, 2 * tile + 1],
                rows=range(tile * TILE, (tile + 1) * TILE))


def al128(b: int) -> int:
    return (b + 127) // 128 * 128


def ring_stages(off: int, slab_k: int, width: int = MAX_N, bar_sets: int = 2
                ) -> tuple:
    """csrc/pe_tile.cuh ``ring_layout``: (stages, total bytes) of the slab
    ring after ``off`` bytes and ``bar_sets`` barrier arrays, slabs of
    ``slab_k`` rows ``width`` wide."""
    ring = al128(off + bar_sets * RING_STAGES * 8)
    stage = slab_k * width * 2
    stages = min(RING_STAGES, (MAX_SMEM_BYTES - ring) // stage)
    return stages, ring + stages * stage


def bwd_tile_smem(h) -> tuple:
    """(dynamic shared memory, ring stages) of the backward's tile kernel
    for the program with header ``h``: ``fused_pe_field_bwd.cu``
    ``tile_layout``.  A wide program keeps one region for the block,
    slabs as wide as ``PASS_W`` and a cluster ring (its peer barriers after
    the full and empty ones); in class 2 its relu masks are in device
    memory (``cropnerf_pe_field_bwd_sizes``' out[5])."""
    wc = width_class([h[H_ACT_W]])
    u = al128(BLOCK * h[H_DIM] * 4)
    off = (u + al128(BLOCK * h[H_ENC_PAD] * 2) + al128(BLOCK * h[H_TB_W] * 2)
           + al128(BLOCK * h[H_TB_W] * 4))
    off = max(off, u + al128(BLOCK * h[H_ENC_PAD] * 4))
    off += al128(BLOCK * h[H_ACT_W] * 2) + (2 if wc else 1) * 4 * MAX_N * 4
    off = (1 if wc else 2) * off
    if wc != 2:
        off += al128(h[H_MASK_WORDS] * 2 * 128 * 4)
    stages, total = ring_stages(off, SLAB_K, PASS_W if wc else MAX_N,
                                CLUSTER_BAR_SETS if wc else 2)
    return total, stages


# ---- the forward's layout and the wide forward's split ---------------------

def fwd_smem(h) -> tuple:
    """(dynamic shared memory, ring stages) of the forward kernel for the
    program with header ``h``: ``fused_pe_field.cu`` ``fwd_layout``.  Each
    consumer warpgroup keeps its region (encoding and output stage, t, the
    activation tile); the block keeps its biases, the ops and the turn
    barriers, a wide program (class 1) also its handshake barriers; then a
    ring of 64-row slabs ``MAX_N`` wide, or in class 1 of 32-row slabs of
    the block's half.  Class 2 keeps one region for the block, no biases
    (read from device memory) and 32-row slabs ``PASS_W`` wide."""
    wc = width_class([h[H_ACT_W]])
    out_cols = max(h[H_T_COLS], h[H_RGB_COLS], h[H_SEM_COLS])
    region = (al128(max(BLOCK * h[H_ENC_PAD] * 2, BLOCK * out_cols * 4))
              + al128(BLOCK * h[H_TB_W] * 2) + al128(BLOCK * h[H_ACT_W] * 2))
    off = (1 if wc == 2 else 2) * region
    off += 0 if wc == 2 else al128(h[H_TOTAL_B] * 4)
    off += al128(h[H_N_OPS] * OP_INTS * 4) + 2 * 8 + (MIRROR_BYTES if wc == 1
                                                      else 0)
    stages, total = (ring_stages(off, SLAB_K, PASS_W) if wc == 2
                     else ring_stages(off, SLAB_K if wc else FWD_SLAB))
    return total, stages


def fwd_park_elems(h, sms: int) -> int:
    """uint32 words of the class 2 forward's scratch in device memory
    (``fused_pe_field.cu`` ``run_passes``: a 1024-wide product's first pass
    waits there for the second), a block's ``PARK_WORDS`` a consumer thread
    for each of ``sms`` SMs; none below class 2."""
    if width_class([h[H_ACT_W]]) != 2:
        return 0
    return sms * PARK_WORDS * 2 * 128


def half_slab_index(op, rank: int, slab_k: int = SLAB_K) -> List[List[int]]:
    """The weight-image elements a wide forward block of rank ``rank``
    copies for a product op, slab by slab (``produce_half_slabs``): for
    each 8-row k-group of a slab, the block's half of its N // 8 core
    matrices, one contiguous run of N // 2 * 8 elements; the slab lands as
    the K-major core-matrix image of its [rows, N // 2] half."""
    N, K, img = op[O_N], op[O_K], op[O_IMG]
    half = N // 2
    slabs = []
    for k0 in range(0, K, slab_k):
        idx = []
        for g in range(min(slab_k, K - k0) // 8):
            start = img + ((k0 // 8 + g) * N + rank * half) * 8
            idx += range(start, start + half * 8)
        slabs.append(idx)
    return slabs
