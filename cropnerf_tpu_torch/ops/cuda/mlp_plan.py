"""The programs of the stream route's kernels (``csrc/fused_mlp_stream.cu``):
K3's and K5's relu MLPs that the resident-weight wgmma kernels do not take.

The kernels run the PE field's tile interpreter (``csrc/pe_tile.cuh``) on
ops in ``pe_plan``'s format, with a header of their own.  A net is 1 to
``MAX_LAYERS`` layers on an input of ``din`` columns (K3's x, or K5's
encoding of x [N, dim] with F frequencies), each layer padded as
``common.pack_layers`` pads it ([k rounded up to 16, n rounded up to 16],
biases alike), and each product's output to its width
(``pe_plan.pow2_width``).  Every input and layer is at most ``MAX_W``
(512, ``common.STREAM_MAX_WIDTH``) wide, K5's encoding at most ``MAX_N``
(256); a net with an input or a layer over ``MAX_N`` runs wide (width
class 1, ``pe_plan.width_class``: every
product's columns split in halves; the forward's over a cluster of two
blocks, each warpgroup with one buffer that takes the input too, the
backward's between a block's two warpgroups).  The forward program is one FWD op per layer,
the last writing the f32 output (Y_OUT).  The backward's recomputes the
hidden layers (RELU, with relu masks and workspace slots), takes the last
layer's cotangent from g (EMIT), goes back through the layers in place
(BWD, G_MASKED) and ends with layer 0's input gradient in chunks of
wgmma widths (DX: K3's dx rows; GENC: K5's f32 tile, from which the kernel
forms dx).  With the weight gradients it stores every A_l and G_l to the
workspace (``pe_plan``'s slot layout) and lists the tasks of the
weight-gradient pass (``csrc/pe_dw.cuh``), whose dW comes out in
``pack_layers``' layout.

The weight image and the padded biases are gathered on the card from the
weights' flattened concatenation (``stream_images``) at indices cached per
shape.  Everything here is plain Python, so the CPU tests run the
programs in torch (``tests/test_torch_stream.py``).
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch

from .common import STREAM_MAX_WIDTH, pad16
from .pe_plan import (BWD, CLUSTER_BAR_SETS, EMIT, FWD, MAX_N,
                      MIRROR_BYTES, O_A0, O_A1, O_BOFF, O_COL, O_EPI, O_IMG,
                      O_K, O_KA, O_KIND, O_MASK, O_N, O_NVALID, O_WS,
                      OP_INTS, Plan, al128,
                      core_k_major, dw_tasks, mask_words, pow2_chunks,
                      pow2_width, ring_stages, width_class)

MAX_W = STREAM_MAX_WIDTH  # the widest input and layer of the route (512)
MAX_LAYERS = 32          # the deepest net the stream route takes
MAX_FREQS = 30
MAX_PE_IN = MAX_N        # K5's encoding columns at most

# header of a stream program (csrc/fused_mlp_stream.cu)
(M_DIN, M_IN_PAD, M_DOUT, M_DIM, M_FREQS, M_ACT_W, M_N_OPS, M_N_TASKS,
 M_TOTAL_W, M_TOTAL_B, M_IMG_ELEMS, M_MASK_WORDS, M_WS_COLS, M_IN_SLOT,
 M_STORE, M_HEADER) = range(16)
# a warpgroup's buffers
IN, ACT = range(2)
# epilogues: FWD ops, BWD ops
RELU, Y_OUT = range(2)
G_MASKED, DX, GENC = range(3)

# shared-memory layout constants of the kernels (csrc/pe_tile.cuh): rows
# of a tile, slab rows of the forward (32 when wide) and of the backward,
# ring stages the forward needs and the backward up to MAX_N wide (two
# wgmma groups in flight)
ROWS, FWD_SLAB, BWD_SLAB, MIN_FWD_STAGES, MIN_BWD_STAGES = 64, 64, 32, 3, 3


def stream_takes(din: int, widths: Sequence[int], dim: int = 0,
                 num_freqs: int = 0) -> bool:
    """Whether the stream kernels take a net x [N, din] → ``widths`` (K3,
    ``dim`` 0) or its K5 variant on x [N, dim] with ``num_freqs``
    frequencies (din = dim(1 + 2F) at most 256): 1 to 32 layers, the
    input and every layer at most 512 wide."""
    if dim and not (0 <= num_freqs <= MAX_FREQS and din <= MAX_PE_IN
                    and din == dim * (1 + 2 * num_freqs)):
        return False
    return (1 <= len(widths) <= MAX_LAYERS and 1 <= din <= MAX_W
            and all(1 <= w <= MAX_W for w in widths))


def stream_wide(h: Sequence[int]) -> bool:
    """Whether a stream program (header ``h``) runs wide: its input or a
    layer over ``MAX_N``."""
    return width_class([h[M_IN_PAD], h[M_ACT_W]]) > 0


def stream_layers(din: int, widths: Sequence[int]) -> List[List[int]]:
    """``pack_layers``' layout of the net: per layer (weight offset, bias
    offset, padded k, padded n, padded k)."""
    L, w_off, b_off, k = [], 0, 0, pad16(din)
    for n in widths:
        n_pad = pad16(n)
        L.append([w_off, b_off, k, n_pad, k])
        w_off, b_off, k = w_off + k * n_pad, b_off + n_pad, n_pad
    return L


def _check(din, widths, dim, num_freqs):
    if not stream_takes(din, widths, dim, num_freqs):
        raise ValueError(
            f"the stream kernels take 1 to {MAX_LAYERS} layers with the input "
            f"and every layer at most {MAX_W} wide (K5's encoding at most "
            f"{MAX_PE_IN}, F at most {MAX_FREQS}); got din {din}, widths "
            f"{list(widths)}" + (f", x [N, {dim}], F={num_freqs}" if dim else ""))


class _Ops:
    """The op list being built and the B matrix of each product."""

    def __init__(self, L, nw):
        self.L, self.nw = L, nw
        self.ops, self.images, self.img = [], [], 0

    def other(self, kind, N, **f):
        op = [0] * OP_INTS
        op[O_KIND], op[O_N] = kind, N
        op[O_BOFF] = op[O_MASK] = op[O_WS] = -1
        names = dict(a0=O_A0, ka=O_KA, epi=O_EPI, boff=O_BOFF,
                     nvalid=O_NVALID, mask=O_MASK, ws=O_WS, col=O_COL)
        for k, v in f.items():
            op[names[k]] = v
        op[O_A1] = op[O_A0]
        self.ops.append(op)
        return op

    def product(self, kind, layer, transposed, row0, rows, K, N, **f):
        op = self.other(kind, N, ka=K, **f)
        op[O_K], op[O_IMG] = K, self.img
        self.images.append((layer, transposed, row0, rows, K, N))
        self.img += K * N

    def fwd(self, l, epi, **f):
        _, b_off, k, n, _ = self.L[l]
        self.product(FWD, l, False, 0, k, k, self.nw[l],
                     a0=IN if l == 0 else ACT, epi=epi, boff=b_off, nvalid=n,
                     **f)


def build_stream_plan(din: int, widths: Sequence[int], dim: int = 0,
                      num_freqs: int = 0, backward: bool = False,
                      need_dx: bool = True, need_dw: bool = True) -> Plan:
    """The forward (``backward`` False) or backward program of the net
    x [N, din] → ``widths``: K3 with ``dim`` 0, else K5 on x [N, dim]
    with ``num_freqs`` frequencies.  The backward computes layer 0's input
    gradient only with ``need_dx`` and the weight gradients only with
    ``need_dw`` (no workspace, no bias sums, no tasks without)."""
    _check(din, widths, dim, num_freqs)
    if backward and not (need_dx or need_dw):
        raise ValueError("the backward computes dx, dW or both")
    L, n = stream_layers(din, widths), len(widths)
    nw = [pow2_width(w) for w in widths]
    in_pad = pad16(din)
    wide = width_class(nw + [in_pad]) > 0
    net = _Ops(L, nw)
    store = backward and need_dw
    slots, ws_cols, words, masks, tasks = {}, 0, 0, {}, []

    def slot(name, width):
        nonlocal ws_cols
        if not store:
            return -1
        slots[name] = (ws_cols, width)
        ws_cols += width
        return slots[name][0]

    if not backward:
        for l in range(n):
            net.fwd(l, Y_OUT if l == n - 1 else RELU)
    else:
        slot("in", in_pad)
        for l in range(n - 1):                   # the hidden layers' recompute
            masks[l] = words
            words += mask_words(nw[l], wide)
            net.fwd(l, RELU, mask=masks[l], ws=slot(f"a{l}", nw[l]))
        last = L[n - 1]
        net.other(EMIT, nw[n - 1], boff=last[1] if store else -1,
                  nvalid=last[3], ws=slot(f"g{n - 1}", nw[n - 1]))
        for l in range(n - 1, 0, -1):            # G_{l-1} = mask ⊙ G_l·W_lᵀ
            p = l - 1
            net.product(BWD, l, True, 0, L[l][2], L[l][3], nw[p], a0=ACT,
                        epi=G_MASKED, boff=L[p][1] if store else -1,
                        nvalid=L[p][3], mask=masks[p],
                        ws=slot(f"g{p}", nw[p]))
        if need_dx:                              # layer 0's input gradient
            col = 0
            for N in pow2_chunks(in_pad, MAX_W if wide else MAX_N):
                net.product(BWD, 0, True, col, N, L[0][3], N, a0=ACT,
                            epi=GENC if dim else DX, col=col)
                col += N
        if store:                                # dW_l = A_lᵀ·G_l
            for l in range(n):
                a_col, a_w = slots["in" if l == 0 else f"a{l - 1}"]
                g_col, g_w = slots[f"g{l}"]
                tasks += dw_tasks(a_col, a_w, L[l][2], 0, g_col, g_w,
                                  L[l][3], L[l][0])
    h = [0] * M_HEADER
    h[M_DIN], h[M_IN_PAD], h[M_DOUT] = din, in_pad, widths[-1]
    h[M_DIM], h[M_FREQS] = dim, num_freqs if dim else 0
    h[M_ACT_W] = max(nw)
    h[M_N_OPS], h[M_N_TASKS] = len(net.ops), len(tasks)
    h[M_TOTAL_W] = L[-1][0] + L[-1][2] * L[-1][3]
    h[M_TOTAL_B] = L[-1][1] + L[-1][3]
    h[M_IMG_ELEMS] = net.img
    h[M_MASK_WORDS], h[M_WS_COLS] = words, ws_cols
    h[M_IN_SLOT] = slots["in"][0] if store else -1
    h[M_STORE] = int(store)
    return Plan(h, net.ops, tasks, net.images, slots)


def stream_smem(h: Sequence[int], backward: bool) -> Tuple[int, int]:
    """(dynamic shared memory a block takes, ring stages) of a program
    with header ``h``: csrc/fused_mlp_stream.cu fwd_layout / bwd_layout.
    The forward keeps a region a warpgroup; a wide forward's is one buffer
    as wide as the input and every layer, and its block adds the
    handshake barriers and slabs of 32 rows of its half of the columns
    (``MAX_N``).  A wide backward keeps one region for the block and slabs
    of 32 rows as wide as ``MAX_W``; the backward's ring is a cluster ring
    (``CLUSTER_BAR_SETS`` barrier arrays) of 64-row slabs where
    ``MIN_BWD_STAGES`` of them fit, else of 32-row slabs, or 16 where the
    stages it needs (``MIN_BWD_STAGES`` up to ``MAX_N`` wide, 2 wide) of 32
    do not fit."""
    wide = stream_wide(h)
    copies, width = (1, MAX_W) if wide else (2, MAX_N)
    in_bytes = al128(ROWS * h[M_IN_PAD] * 2)
    act = al128(ROWS * h[M_ACT_W] * 2)
    if not backward:
        region = (al128(ROWS * max(h[M_IN_PAD], h[M_ACT_W]) * 2) if wide
                  else in_bytes + act)
        stages, total = ring_stages(
            2 * region + 16 + (MIRROR_BYTES if wide else 0),
            BWD_SLAB if wide else FWD_SLAB)
        return total, stages
    region = (max(in_bytes, al128(ROWS * h[M_IN_PAD] * 4)) if h[M_DIM]
              else in_bytes)
    off = copies * (region + act) + 2 * 4 * MAX_N * 4    # and the column sums
    for slab, least in ((2 * BWD_SLAB, MIN_BWD_STAGES),
                        (BWD_SLAB, 2 if wide else MIN_BWD_STAGES),
                        (BWD_SLAB // 2, 0)):
        stages, total = ring_stages(off, slab, width, CLUSTER_BAR_SETS)
        if stages >= least:
            return total, stages


@functools.lru_cache(maxsize=None)
def _gather(shapes: tuple, key: tuple, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each element of the weight image of the program ``key``
    (``build_stream_plan``'s arguments) and of the padded biases comes from
    in the flattened concatenation of weights and biases of ``shapes``,
    one zero appended (its index: every padding), on ``device``."""
    plan = stream_plan(key)
    sizes = [math.prod(s) for s in shapes]
    zero = sum(sizes)
    at = torch.arange(zero).split(sizes)
    L = stream_layers(key[0], key[1])
    parts = []
    for layer, transposed, row0, rows, K, N in plan.images:
        w = at[2 * layer].reshape(shapes[2 * layer])
        k, n = w.shape
        idx = torch.full((K, N), zero, dtype=torch.int64)
        if transposed:        # B[j, i] = W[row0 + i, j]
            r = min(rows, max(0, k - row0))
            idx[:n, :r] = w[row0:row0 + r].T
        else:
            idx[:k, :n] = w
        parts.append(core_k_major(idx))
    bias = torch.full((plan.header[M_TOTAL_B],), zero, dtype=torch.int64)
    for l, (_, b_off, _, _, _) in enumerate(L):
        b = at[2 * l + 1]
        bias[b_off:b_off + b.numel()] = b
    img = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    return (img.to(device), bias.to(device),
            torch.zeros(1, device=device))


def stream_images(wbs: Sequence[torch.Tensor], key: tuple
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bf16 weight image, f32 padded biases) of the program ``key``
    (``build_stream_plan``'s arguments) for the weights ``wbs``, on their
    device: one concatenation and two gathers."""
    img_at, bias_at, zero = _gather(tuple(tuple(t.shape) for t in wbs), key,
                                    wbs[0].device)
    flat = torch.cat([t.reshape(-1) for t in wbs] + [zero]).float()
    return (flat.index_select(0, img_at).to(torch.bfloat16),
            flat.index_select(0, bias_at))


def program_key(din: int, widths: Sequence[int], dim: int, num_freqs: int,
                backward: bool, need_dx: bool = True,
                need_dw: bool = True) -> tuple:
    """The hashable arguments of a program (``build_stream_plan``)."""
    if not backward:
        need_dx = need_dw = True
    return (din, tuple(widths), dim, num_freqs if dim else 0, backward,
            need_dx, need_dw)


@functools.lru_cache(maxsize=64)
def stream_plan(key: tuple) -> Plan:
    """``build_stream_plan`` of a ``program_key``, built once."""
    return build_stream_plan(*key)
