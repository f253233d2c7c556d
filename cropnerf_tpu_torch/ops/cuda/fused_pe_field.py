"""Fused positional-encoding NeRF field (counterpart of
``cropnerf_tpu/ops/pallas/fused_pe_field.py``).

``fused_pe_density`` (trunk only) and ``fused_pe_nerf`` (trunk + colour +
semantic heads) launch the CUDA kernel ``csrc/fused_pe_field.cu`` for
tensors on the card and compute ``fused_pe_density_plain`` /
``fused_pe_nerf_plain``, the same arithmetic in plain PyTorch, for tensors
on the CPU.  The kernel replaces the Pallas ``_fwd_kernel`` and
``_mega_fwd_kernel``.  It is compute-bound on an H100 (see the source
note): every intermediate stays in shared memory, the weights stream from
L2.  ``pe_plan.py`` plans it (``build_forward_plan``: the program and its
``wgmma`` weight image); the kernel runs that program on the tile
interpreter it shares with the backward.  The trunk and the heads take
layers up to 1024 wide (``common.MAX_WIDTH``), their output layers up to
512; a layer over 256 makes the program wide (``pe_plan.width_class`` 1:
every product's columns split in halves, the forward's over a persistent
cluster of two blocks, ``fwd_grid``, whose refusal raises), a layer over
512 puts it in class 2 (both warpgroups on one 64-row tile, a 1024-wide
product in two passes, the backward's relu masks in device memory), and a
wider layer, or a layout over a block's shared memory, raises on the card
with its reason.  The ragged tail of N is masked in the kernel; there is
no fallback.

Both are differentiable.  On the card their backwards are
``fused_pe_nerf_bwd`` and ``fused_pe_density_bwd``, the CUDA kernels of
``csrc/fused_pe_field_bwd.cu`` with and without the heads (replacing
``_mega_bwd_kernel`` and ``_bwd_kernel``), which recompute the forward;
``pe_plan.py`` plans them too (the tile program, the ``wgmma`` weight
image, the workspace and the weight-gradient tasks).
``fused_pe_density_bwd`` computes only the gradients autograd asks for
(dx alone in the BayesRays pass).  On the CPU autograd runs through the
plain versions.

``fused_pe_mlp`` (the PE proposal nets with ``mlp_impl="pallas-fused"``:
encode, then a relu MLP to [N, 1]) launches, for tensors on the card, a
forward kernel (replacing ``_plain_fwd_kernel``) and a recompute backward
(replacing ``_plain_bwd_kernel``).  The net's shape picks them
(``pe_mlp_fwd_route``): "wgmma", hidden layers up to 64 wide (every
preset's 64-wide nets), ``csrc/fused_pe_mlp_fwd.cu`` and
``csrc/fused_pe_mlp_bwd.cu``; "wide", hidden layers padded to 128 or 256
(``cropnerf-mxu-q``'s 128-wide nets), the PE variant of
``csrc/fused_mlp_fwd.cu`` and, with weight gradients,
``csrc/fused_pe_mlp_wide_bwd.cu`` (each block's weight sums kept in a
warpgroup's registers across its tiles; dx alone the PE variant of
``csrc/fused_mlp_bwd.cu``); both persistent warpgroups on ``wgmma`` with
the net resident in shared memory, on the weight images
``pe_mlp_images`` builds once per call (the forward half alone where no
graph is recorded) and the backward reuses; launches counted on
``fused_pe_mlp`` and ``fused_pe_mlp_bwd``.  Every other net of 1 to 32
layers whose layers are at most 512 wide and whose encoding is at most 256
("stream": 4 layers, 17 outputs, more than 64 encoding columns, x not
[N, 3], a wide net too large for shared memory, such as
``cropnerf-mxu-q``'s nets at 256 wide, or a net over 256 wide, which runs
with both warpgroups on one tile, each half of every product) runs on
``csrc/fused_mlp_stream.cu``, the weights streamed through shared memory,
forward and backward (counted on ``fused_pe_mlp_stream`` and
``fused_pe_mlp_stream_bwd``); so on the card every such net records a
graph.  A wider net has no kernel and raises on the card.  On the CPU it computes ``fused_pe_mlp_plain``.  The JAX
selector argument ``s`` (zero gradient) has no counterpart: the kernels
and the plain version build the encoding from the frequencies.

Rounding points follow the JAX kernels: the encoding is rounded to the
compute dtype before base layer 0, every hidden layer applies relu then
rounds, the skip layer sums its two partial products in float32, and the
trunk output ``t`` and the extras are rounded before the heads.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..mlp import mm_f32acc
from . import build
from .fused_mlp import (_least_bwd_smem, cluster_refusal, fused_mlp_plain,
                        mlp_hidden_pad, mlp_images, stream_backward,
                        stream_forward, wgmma_backward, wgmma_forward)
from .mlp_plan import (MAX_FREQS, MAX_LAYERS, MAX_PE_IN, stream_takes)
from .pe_plan import (H_HEADER, build_forward_plan, build_plan,
                      fwd_park_elems, image_index, weight_image)
from .common import (MAX_SMEM_BYTES, PE_DIM, PE_ENC, STREAM_MAX_WIDTH,
                     WGMMA_HIDDEN, WGMMA_OUT, c_ints, check_images,
                     check_kernel_call, check_rows, pack_layers, pad16,
                     stream_ptr, unpack_layers, weight_images)
from .common import persistent_blocks as pe_mlp_blocks
from .common import sm_count


def pe_selector_matrix(num_freqs: int, min_freq_exp: float = 0.0,
                       max_freq_exp: float | None = None,
                       dim: int = 3) -> np.ndarray:
    """S [dim, dim(1+2F)] with (x @ S) the pre-activation of
    ``ops.posenc.nerf_encoding``, in its column order."""
    if max_freq_exp is None:
        max_freq_exp = num_freqs - 1
    freqs = 2.0 ** np.linspace(min_freq_exp, max_freq_exp, num_freqs)
    width = dim * (1 + 2 * num_freqs)
    s = np.zeros((dim, width), np.float32)
    for d in range(dim):
        s[d, d] = 1.0
    for f in range(num_freqs):
        for d in range(dim):
            s[d, dim + f * dim + d] = freqs[f]                    # sin block
            s[d, dim * (1 + num_freqs) + f * dim + d] = freqs[f]  # cos block
    return s


def _encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Identity/sin/cos columns of the selector product, in float32."""
    dim = x.shape[-1]
    s = torch.from_numpy(pe_selector_matrix(num_freqs, dim=dim)).to(x.device)
    pre = x.float() @ s
    col = torch.arange(pre.shape[-1], device=x.device)
    sin_end = dim * (1 + num_freqs)
    return torch.where(col < dim, pre,
                       torch.where(col < sin_end, torch.sin(pre),
                                   torch.cos(pre)))


def fused_pe_density_plain(x: torch.Tensor, base_wbs: Sequence[torch.Tensor],
                           top_wbs: Sequence[torch.Tensor], num_freqs: int,
                           compute_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain-PyTorch trunk (≙ the JAX ``_ref_forward``): x [N, dim] →
    t [N, Dout] float32."""
    cd = compute_dtype
    H = base_wbs[-2].shape[1]
    enc = _encode(x, num_freqs).to(cd)
    h = enc
    for i in range(len(base_wbs) // 2):
        h = mm_f32acc(h, base_wbs[2 * i], cd) + base_wbs[2 * i + 1]
        h = torch.relu(h).to(cd)
    wt0 = top_wbs[0]
    t = mm_f32acc(h, wt0[:H], cd) + mm_f32acc(enc, wt0[H:], cd) + top_wbs[1]
    for i in range(1, len(top_wbs) // 2):
        t = torch.relu(t).to(cd)
        t = mm_f32acc(t, top_wbs[2 * i], cd) + top_wbs[2 * i + 1]
    return t.float()


def fused_pe_nerf_plain(x: torch.Tensor, extras: torch.Tensor,
                        base_wbs: Sequence[torch.Tensor],
                        top_wbs: Sequence[torch.Tensor],
                        color_wbs: Sequence[torch.Tensor],
                        sem_wbs: Sequence[torch.Tensor], num_freqs: int,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        pass_sem_grad: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch trunk + heads (≙ the JAX ``_mega_ref``).  The semantic
    head reads a detached trunk output unless ``pass_sem_grad``."""
    t = fused_pe_density_plain(x, base_wbs, top_wbs, num_freqs,
                               compute_dtype)
    return (t, *heads_plain(t, extras, color_wbs, sem_wbs, compute_dtype,
                            pass_sem_grad))


def heads_plain(t: torch.Tensor, extras: torch.Tensor,
                color_wbs: Sequence[torch.Tensor],
                sem_wbs: Sequence[torch.Tensor],
                compute_dtype: torch.dtype = torch.bfloat16,
                pass_sem_grad: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The colour and semantic heads of ``fused_pe_nerf_plain`` on the trunk
    output t [N, 1+G] (rounded to ``compute_dtype`` first): (rgb_raw,
    sem_raw) in float32."""
    cd = compute_dtype
    tb = t.to(cd)
    ex = extras.to(cd)
    c = (mm_f32acc(tb, color_wbs[0], cd) + mm_f32acc(ex, color_wbs[1], cd)
         + color_wbs[2])
    for i in range(1, (len(color_wbs) - 1) // 2):
        c = torch.relu(c).to(cd)
        c = mm_f32acc(c, color_wbs[2 * i + 1], cd) + color_wbs[2 * i + 2]
    ts = tb if pass_sem_grad else tb.detach()
    sm = mm_f32acc(ts, sem_wbs[0], cd) + sem_wbs[1]
    for i in range(1, len(sem_wbs) // 2):
        sm = torch.relu(sm).to(cd)
        sm = mm_f32acc(sm, sem_wbs[2 * i], cd) + sem_wbs[2 * i + 1]
    return c.float(), sm.float()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fused_pe_field")
    lib.cropnerf_pe_field_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.cropnerf_pe_field_fwd.restype = ctypes.c_int
    lib.cropnerf_pe_field_fwd_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cropnerf_pe_field_fwd_smem_bytes.restype = ctypes.c_int
    lib.cropnerf_pe_field_fwd_grid.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.cropnerf_pe_field_fwd_grid.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = build.load("fused_pe_field_bwd")
    lib.cropnerf_pe_field_bwd.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong] + [ctypes.c_void_p] * 7
    lib.cropnerf_pe_field_bwd.restype = ctypes.c_int
    for f in ("sizes", "grid"):
        getattr(lib, f"cropnerf_pe_field_bwd_{f}").argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        getattr(lib, f"cropnerf_pe_field_bwd_{f}").restype = ctypes.c_int
    lib.cropnerf_pe_field_bwd_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cropnerf_pe_field_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def _pairs(wbs: Sequence[torch.Tensor]):
    return [(wbs[2 * i], wbs[2 * i + 1]) for i in range(len(wbs) // 2)]


def _pe_layers(dim: int, num_freqs: int, base_wbs, top_wbs, color_wbs=None,
               sem_wbs=None, de: int = 0):
    """(layers for ``pack_layers``, meta header) of the field; the header's
    last entry, the widest padded layer, is filled in by the packing."""
    enc_cols = dim * (1 + 2 * num_freqs)
    enc_pad = pad16(enc_cols)
    H = base_wbs[-2].shape[1]
    layers, k = [], enc_cols
    for w, b in _pairs(base_wbs):
        if w.shape[0] != k:
            raise ValueError(f"base weight {tuple(w.shape)} does not take {k}")
        layers.append(([(w, pad16(k))], b))
        k = w.shape[1]
    wt0 = top_wbs[0]
    if wt0.shape[0] != H + enc_cols:
        raise ValueError(f"skip weight {tuple(wt0.shape)} does not take "
                         f"[h {H} | enc {enc_cols}]")
    layers.append(([(wt0[:H], pad16(H)), (wt0[H:], enc_pad)], top_wbs[1]))
    layers += [([(w, pad16(w.shape[0]))], b) for w, b in _pairs(top_wbs[2:])]
    t_cols = top_wbs[-2].shape[1]
    n_color = n_sem = rgb_cols = sem_cols = 0
    ex_pad = pad16(de) if color_wbs is not None else 0
    if color_wbs is not None:
        if color_wbs[0].shape[0] != t_cols or sem_wbs[0].shape[0] != t_cols:
            raise ValueError("head layer-0 weights must take the trunk output "
                             f"[1+G = {t_cols}] (zero top row)")
        if color_wbs[1].shape[0] != de:
            raise ValueError(f"colour extras weight takes "
                             f"{color_wbs[1].shape[0]}, extras have {de}")
        layers.append(([(color_wbs[0], pad16(t_cols)), (color_wbs[1], ex_pad)],
                       color_wbs[2]))
        layers += [([(w, pad16(w.shape[0]))], b)
                   for w, b in _pairs(color_wbs[3:])]
        layers.append(([(sem_wbs[0], pad16(t_cols))], sem_wbs[1]))
        layers += [([(w, pad16(w.shape[0]))], b)
                   for w, b in _pairs(sem_wbs[2:])]
        n_color = (len(color_wbs) - 1) // 2
        n_sem = len(sem_wbs) // 2
        rgb_cols = color_wbs[-2].shape[1] if n_color > 1 else color_wbs[0].shape[1]
        sem_cols = sem_wbs[-2].shape[1]
    header = [dim, num_freqs, enc_cols, enc_pad, de, ex_pad,
              len(base_wbs) // 2, len(top_wbs) // 2, n_color, n_sem,
              t_cols, rgb_cols, sem_cols]
    return layers, header


def pack_pe_field(dim: int, num_freqs: int, base_wbs, top_wbs,
                  color_wbs=None, sem_wbs=None, de: int = 0,
                  device: torch.device | str = "cpu"):
    """(bf16 weights, f32 biases, meta ints) as the kernels take them.
    Heads are packed when ``color_wbs``/``sem_wbs`` are given."""
    layers, header = _pe_layers(dim, num_freqs, base_wbs, top_wbs, color_wbs,
                                sem_wbs, de)
    wbuf, bbuf, descs = pack_layers(layers, torch.device(device))
    return wbuf, bbuf, header + [max(descs[3::5])] + descs


def unpack_pe_field_grads(dwbuf: torch.Tensor, dbbuf: torch.Tensor, meta,
                          base_wbs, top_wbs, color_wbs=None, sem_wbs=None):
    """The packed f32 gradient buffers of the backward kernel → gradients
    in the caller's shapes: (d base_wbs, d top_wbs, d color_wbs,
    d sem_wbs), each a list parallel to its weights (the heads' lists
    empty without heads).  The skip layer's gradient is its h block stacked
    on its enc block."""
    layers, _ = _pe_layers(meta[0], meta[1], base_wbs, top_wbs, color_wbs,
                           sem_wbs, meta[4])
    per_layer = unpack_layers(layers, dwbuf, dbbuf, meta[14:])
    nb, nt = len(base_wbs) // 2, len(top_wbs) // 2
    nc = (len(color_wbs) - 1) // 2 if color_wbs is not None else 0
    flat = lambda ls: [g for ws, db in ls for g in (*ws, db)]  # noqa: E731
    d_base = flat(per_layer[:nb])
    (dh, de), db0 = per_layer[nb]
    d_top = [torch.cat([dh, de], dim=0), db0] + flat(per_layer[nb + 1:nb + nt])
    d_color = flat(per_layer[nb + nt:nb + nt + nc])
    d_sem = flat(per_layer[nb + nt + nc:])
    return d_base, d_top, d_color, d_sem


def smem_bytes(meta, heads: bool) -> int:
    """Dynamic shared memory one block of the forward kernel takes for
    ``meta`` (-1 where the kernel rejects the layout)."""
    prog = build_forward_plan(meta, heads).ints()
    return _lib().cropnerf_pe_field_fwd_smem_bytes(c_ints(prog), len(prog))


def fwd_grid(meta, heads: bool, n_rows: int) -> dict:
    """The forward's grid at ``n_rows`` rows on the current card: the
    cluster size (0 up to 256 wide and over 512: persistent blocks), the
    clusters resident at once (0 without clusters), the blocks launched,
    and the C function's return (0, or the cudaError that refuses the
    launch)."""
    prog = build_forward_plan(meta, heads).ints()
    out = (ctypes.c_longlong * 3)()
    err = _lib().cropnerf_pe_field_fwd_grid(c_ints(prog), len(prog), n_rows,
                                            out)
    if err == -1:
        raise ValueError("the kernel rejects this layout")
    return dict(cluster=out[0], active_clusters=out[1], blocks=out[2],
                error=err)


@functools.lru_cache(maxsize=16)
def _program(meta: tuple, device: torch.device, heads: bool,
             backward: bool = False, pass_sem: bool = False,
             need_dw: bool = False):
    """(plan, its ints on the host, the same on the device, the weight
    image's gather index on the device) of one layout of the forward or
    backward kernel, built once: a copy from host memory to the card waits
    for the stream, so it is not made on every call."""
    meta = list(meta)
    plan = (build_plan(meta, heads, pass_sem, need_dw) if backward
            else build_forward_plan(meta, heads))
    prog = plan.ints()
    return (plan, prog, torch.tensor(prog, dtype=torch.int32, device=device),
            image_index(meta, plan).to(device))


def _launch(name, x, extras, outs, wbuf, bbuf, meta, heads, device):
    """One launch of the forward kernel on the program pe_plan.py plans."""
    lib = _lib()
    try:
        _, prog, prog_dev, index = _program(tuple(meta), device, heads)
    except ValueError as e:
        raise ValueError(f"{name}: the kernel rejects this layout ({e})") from e
    smem = lib.cropnerf_pe_field_fwd_smem_bytes(c_ints(prog), len(prog))
    if smem < 0:
        raise ValueError(f"{name}: the kernel rejects this network layout")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    img = weight_image(wbuf, index)
    n_park = fwd_park_elems(prog[:H_HEADER], sm_count(device))
    park = (torch.empty((n_park,), dtype=torch.int32, device=device)
            if n_park else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        err = lib.cropnerf_pe_field_fwd(
            x.data_ptr(), ptr(extras), *[ptr(o) for o in outs],
            img.data_ptr(), bbuf.data_ptr(), ptr(park), c_ints(prog),
            prog_dev.data_ptr(), len(prog), x.shape[0], stream_ptr(device))
    if err:
        grid = fwd_grid(meta, heads, x.shape[0])
        if grid["error"]:
            raise RuntimeError(cluster_refusal(name, err, grid, smem))
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _density_forward(x, base_wbs, top_wbs, num_freqs, device):
    wbuf, bbuf, meta = pack_pe_field(x.shape[1], num_freqs, base_wbs,
                                     top_wbs, device=device)
    t = torch.empty((x.shape[0], top_wbs[-2].shape[1]), dtype=torch.float32,
                    device=device)
    if x.shape[0] == 0:
        return t
    _launch("fused_pe_density", x, None, (t, None, None), wbuf, bbuf, meta,
            False, device)
    fused_pe_density.launches += 1
    return t


def fused_pe_density(x: torch.Tensor, base_wbs: Sequence[torch.Tensor],
                     top_wbs: Sequence[torch.Tensor], num_freqs: int,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """x [N, dim] float32 (encoder domain, unit*2-1) → t [N, Dout] float32,
    differentiable in x and the weights.

    base_wbs/top_wbs = [W0, b0, W1, b1, ...]; W_top0 is the skip layer
    [H + dim(1+2F), H_top]."""
    check_rows("x", x)
    if x.device.type == "cpu":
        return fused_pe_density_plain(x, base_wbs, top_wbs, num_freqs,
                                      compute_dtype)
    check_kernel_call("fused_pe_density", [x, *base_wbs, *top_wbs],
                      compute_dtype)
    return _FusedPeDensity.apply(x, num_freqs, len(base_wbs), *base_wbs,
                                 *top_wbs)


def _nerf_forward(x, extras, base_wbs, top_wbs, color_wbs, sem_wbs,
                  num_freqs, device):
    wbuf, bbuf, meta = pack_pe_field(x.shape[1], num_freqs, base_wbs,
                                     top_wbs, color_wbs, sem_wbs,
                                     de=extras.shape[1], device=device)
    n = x.shape[0]
    t_cols, rgb_cols, sem_cols = meta[10], meta[11], meta[12]
    outs = tuple(torch.empty((n, c), dtype=torch.float32, device=device)
                 for c in (t_cols, rgb_cols, sem_cols))
    if n == 0:
        return outs
    _launch("fused_pe_nerf", x, extras, outs, wbuf, bbuf, meta, True, device)
    fused_pe_nerf.launches += 1
    return outs


def bwd_smem_bytes(meta, heads: bool = True) -> int:
    """Dynamic shared memory one block of the backward's tile kernel takes
    (-1 where the kernel rejects the layout)."""
    prog = build_plan(meta, heads, False, True).ints()
    return _bwd_lib().cropnerf_pe_field_bwd_smem_bytes(c_ints(prog), len(prog))


def bwd_grid(meta, heads: bool, need_dw: bool, n_rows: int) -> dict:
    """The grid of the backward's tile kernel (dx with the weight
    gradients, or dx alone) at ``n_rows`` rows on the current card: the
    cluster size (0 up to 256 wide: one block a tile), the clusters resident
    at once, the blocks launched, and the C function's return (0, or the
    cudaError that refuses the launch)."""
    prog = build_plan(meta, heads, False, need_dw).ints()
    out = (ctypes.c_longlong * 3)()
    err = _bwd_lib().cropnerf_pe_field_bwd_grid(c_ints(prog), len(prog),
                                                n_rows, out)
    if err == -1:
        raise ValueError("the kernel rejects this layout")
    return dict(cluster=out[0], active_clusters=out[1], blocks=out[2],
                error=err)


def _bwd_launch(name, x, extras, cots, dx, dex, wbuf, bbuf, meta, heads,
                pass_sem, need_dw, device):
    """One launch of the backward kernel (pe_plan.py plans it): the
    program, the weight image, the workspace, the relu masks in device
    memory (class 2) and partials, then (dw, db) packed, or None without
    weight gradients."""
    lib = _bwd_lib()
    n = x.shape[0]
    try:
        plan, prog, prog_dev, index = _program(
            tuple(meta), device, heads, True, pass_sem, need_dw)
    except ValueError as e:
        raise ValueError(f"{name}: the kernel rejects this layout ({e})") from e
    sizes = (ctypes.c_longlong * 6)()
    err = lib.cropnerf_pe_field_bwd_sizes(c_ints(prog), len(prog), n, sizes)
    if err == -1:
        raise ValueError(f"{name}: the kernel rejects this layout")
    if err:
        raise RuntimeError(f"{name}: the device query failed: cudaError {err}")
    smem = lib.cropnerf_pe_field_bwd_smem_bytes(c_ints(prog), len(prog))
    if not 0 < smem <= MAX_SMEM_BYTES:
        raise ValueError(f"{name}: needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    ws_elems, n_bpart, n_wpart, total_w, total_b, n_masks = list(sizes)
    f32 = dict(dtype=torch.float32, device=device)
    dw = db = None
    ptrs = [None] * 4
    if need_dw:
        dw, db = torch.zeros((total_w,), **f32), torch.zeros((total_b,), **f32)
        if n:
            bpart = torch.empty((n_bpart,), **f32)
            wpart = torch.empty((n_wpart,), **f32)
            ptrs = [t.data_ptr() for t in (bpart, wpart, dw, db)]
    if n:
        img = weight_image(wbuf, index)
        ws = (torch.empty((ws_elems,), dtype=torch.bfloat16, device=device)
              if ws_elems else None)
        masks = (torch.empty((n_masks,), dtype=torch.int32, device=device)
                 if n_masks else None)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            err = lib.cropnerf_pe_field_bwd(
                x.data_ptr(), ptr(extras), *[ptr(c) for c in cots], ptr(dx),
                ptr(dex), img.data_ptr(), bbuf.data_ptr(), c_ints(prog),
                prog_dev.data_ptr(), len(prog), n, ptr(ws), ptr(masks), *ptrs,
                stream_ptr(device))
        if err:
            grid = bwd_grid(meta, heads, need_dw, n)
            if grid["error"]:
                raise RuntimeError(cluster_refusal(name, err, grid, smem))
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return (dw, db) if need_dw else None


@torch.no_grad()
def fused_pe_density_bwd(x: torch.Tensor, base_wbs: Sequence[torch.Tensor],
                         top_wbs: Sequence[torch.Tensor], num_freqs: int,
                         g_t: torch.Tensor, need_dx: bool = True,
                         need_dw: bool = True):
    """The backward kernel of ``fused_pe_density`` on CUDA tensors: the
    cotangent of t → (dx or None, d base_wbs, d top_wbs) in float32, the
    weight gradients in the callers' shapes or None without ``need_dw``.
    It recomputes the forward from x and the weights."""
    device = check_kernel_call("fused_pe_density_bwd",
                               [x, g_t, *base_wbs, *top_wbs], torch.bfloat16)
    wbuf, bbuf, meta = pack_pe_field(x.shape[1], num_freqs, base_wbs,
                                     top_wbs, device=device)
    check_rows("g_t", g_t, n=x.shape[0], cols=meta[10])
    dx = torch.empty_like(x) if need_dx else None
    packed = _bwd_launch("fused_pe_density_bwd", x, None, (g_t, None, None),
                         dx, None, wbuf, bbuf, meta, False, False, need_dw,
                         device)
    if x.shape[0]:
        fused_pe_density_bwd.launches += 1
    if not need_dw:
        return dx, None, None
    d_base, d_top, _, _ = unpack_pe_field_grads(*packed, meta, base_wbs,
                                                top_wbs)
    return dx, d_base, d_top


class _FusedPeDensity(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient, run only
    for the gradients asked for.  Saves only x and the weights, as the JAX
    ``_fwd`` does."""

    @staticmethod
    def forward(ctx, x, num_freqs, nb, *wbs):
        ctx.save_for_backward(x, *wbs)
        ctx.config = (num_freqs, nb)
        return _density_forward(x, wbs[:nb], wbs[nb:], num_freqs, x.device)

    @staticmethod
    def backward(ctx, g_t):
        x, *wbs = ctx.saved_tensors
        num_freqs, nb = ctx.config
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[3:])
        dx, d_base, d_top = fused_pe_density_bwd(
            x, wbs[:nb], wbs[nb:], num_freqs, g_t.contiguous(), need_dx,
            need_dw)
        d_w = [*d_base, *d_top] if need_dw else [None] * len(wbs)
        return (dx, None, None, *d_w)


@torch.no_grad()
def fused_pe_nerf_bwd(x: torch.Tensor, extras: torch.Tensor,
                      base_wbs: Sequence[torch.Tensor],
                      top_wbs: Sequence[torch.Tensor],
                      color_wbs: Sequence[torch.Tensor],
                      sem_wbs: Sequence[torch.Tensor], num_freqs: int,
                      g_t: torch.Tensor, g_rgb: torch.Tensor,
                      g_sem: torch.Tensor, pass_sem_grad: bool = False):
    """The backward kernel of ``fused_pe_nerf`` on CUDA tensors: the
    cotangents of (t, rgb_raw, sem_raw) → (dx, dextras, d base_wbs,
    d top_wbs, d color_wbs, d sem_wbs) in float32, in the callers' shapes.
    It recomputes the forward from x, extras and the weights."""
    device = check_kernel_call(
        "fused_pe_nerf_bwd",
        [x, extras, g_t, g_rgb, g_sem, *base_wbs, *top_wbs, *color_wbs,
         *sem_wbs], torch.bfloat16)
    n = x.shape[0]
    wbuf, bbuf, meta = pack_pe_field(x.shape[1], num_freqs, base_wbs,
                                     top_wbs, color_wbs, sem_wbs,
                                     de=extras.shape[1], device=device)
    for name, g, c in (("g_t", g_t, meta[10]), ("g_rgb", g_rgb, meta[11]),
                       ("g_sem", g_sem, meta[12])):
        check_rows(name, g, n=n, cols=c)
    dx = torch.empty_like(x)
    dex = torch.empty_like(extras)
    dw, db = _bwd_launch("fused_pe_nerf_bwd", x, extras, (g_t, g_rgb, g_sem),
                         dx, dex, wbuf, bbuf, meta, True, pass_sem_grad, True,
                         device)
    if n:
        fused_pe_nerf_bwd.launches += 1
    return (dx, dex, *unpack_pe_field_grads(dw, db, meta, base_wbs, top_wbs,
                                            color_wbs, sem_wbs))


class _FusedPeNerf(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient.  Saves only
    x, the extras and the weights, as the JAX ``_mega_fwd`` does."""

    @staticmethod
    def forward(ctx, x, extras, num_freqs, pass_sem_grad, counts, *wbs):
        nb, nt, nc = counts
        base, top = wbs[:nb], wbs[nb:nb + nt]
        color, sem = wbs[nb + nt:nb + nt + nc], wbs[nb + nt + nc:]
        ctx.save_for_backward(x, extras, *wbs)
        ctx.config = (num_freqs, pass_sem_grad, counts)
        outs = _nerf_forward(x, extras, base, top, color, sem, num_freqs,
                             x.device)
        return outs

    @staticmethod
    def backward(ctx, g_t, g_rgb, g_sem):
        x, extras, *wbs = ctx.saved_tensors
        num_freqs, pass_sem_grad, (nb, nt, nc) = ctx.config
        base, top = wbs[:nb], wbs[nb:nb + nt]
        color, sem = wbs[nb + nt:nb + nt + nc], wbs[nb + nt + nc:]
        dx, dex, d_base, d_top, d_color, d_sem = fused_pe_nerf_bwd(
            x, extras, base, top, color, sem, num_freqs,
            g_t.contiguous(), g_rgb.contiguous(), g_sem.contiguous(),
            pass_sem_grad)
        return (dx, dex, None, None, None, *d_base, *d_top, *d_color, *d_sem)


def fused_pe_nerf(x: torch.Tensor, extras: torch.Tensor,
                  base_wbs: Sequence[torch.Tensor],
                  top_wbs: Sequence[torch.Tensor],
                  color_wbs: Sequence[torch.Tensor],
                  sem_wbs: Sequence[torch.Tensor], num_freqs: int,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  pass_sem_grad: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trunk + colour head + semantic head in one kernel, differentiable.

    x [N, dim] float32; extras [N, De] float32 (direction encoding ‖
    appearance row per sample).  color_wbs = [WcT_pad (1+G, Hc), WcE
    (De, Hc), bc0, Wc1, bc1, ...], sem_wbs = [WsT_pad (1+G, Hs), bs0, Ws1,
    bs1, ...], head layer-0 weights with a zero top row.  Returns
    (t [N, 1+G], rgb_raw [N, 3], sem_raw [N, C]) in float32.  The
    semantic head's gradient stops at its own weights unless
    ``pass_sem_grad``."""
    check_rows("x", x)
    check_rows("extras", extras, n=x.shape[0])
    if x.device.type == "cpu":
        return fused_pe_nerf_plain(x, extras, base_wbs, top_wbs, color_wbs,
                                   sem_wbs, num_freqs, compute_dtype,
                                   pass_sem_grad)
    wbs = [*base_wbs, *top_wbs, *color_wbs, *sem_wbs]
    check_kernel_call("fused_pe_nerf", [x, extras, *wbs], compute_dtype)
    counts = (len(base_wbs), len(top_wbs), len(color_wbs))
    return _FusedPeNerf.apply(x, extras, num_freqs, pass_sem_grad, counts,
                              *wbs)


# ---- fused_pe_mlp: the PE proposal nets ------------------------------------

def fused_pe_mlp_plain(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                       num_freqs: int,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Plain-PyTorch PE MLP (≙ the JAX ``_plain_ref``): x [N, dim] →
    encoding rounded to ``compute_dtype`` → relu hidden layers (each
    rounded) → linear last layer → [N, Dout] float32."""
    return fused_mlp_plain(_encode(x, num_freqs).to(compute_dtype), wbs,
                           compute_dtype)


def _check_pe_mlp(x, wbs, num_freqs) -> int:
    """The encoding width the first weight must take; raises on a bad call."""
    if len(wbs) < 2 or len(wbs) % 2:
        raise ValueError("wbs must be [W0, b0, W1, b1, ...]")
    check_rows("x", x)
    k = enc = x.shape[1] * (1 + 2 * num_freqs)
    for w in wbs[0::2]:
        if w.dim() != 2 or w.shape[0] != k:
            raise ValueError(f"weight {tuple(w.shape)} does not take width {k}")
        k = w.shape[1]
    return enc


# csrc/wgmma_mlp.cuh: the widths the kernels' layout pads every net to, the
# coordinates of x; the warpgroups a block of the backward and the forward
PE_MLP_HIDDEN, PE_MLP_OUT, PE_MLP_ENC, PE_MLP_DIM = (WGMMA_HIDDEN, WGMMA_OUT,
                                                     PE_ENC, PE_DIM)
PE_MLP_WGS, PE_MLP_FWD_WGS = 3, 4


def pe_mlp_kernels_take(dim: int, num_freqs: int,
                        widths: Sequence[int]) -> bool:
    """Whether the wgmma kernels (``csrc/fused_pe_mlp_fwd.cu`` and
    ``csrc/fused_pe_mlp_bwd.cu``) take a net: x [N, 3], an encoding of at
    most 64 columns, 2 or 3 layers of output widths ``widths``, hidden
    layers at most 64 wide and at most 16 outputs."""
    return (dim == PE_MLP_DIM and dim * (1 + 2 * num_freqs) <= PE_MLP_ENC
            and len(widths) in (2, 3)
            and all(h <= PE_MLP_HIDDEN for h in widths[:-1])
            and widths[-1] <= PE_MLP_OUT)


def pe_mlp_fwd_route(dim: int, num_freqs: int, widths: Sequence[int]) -> str:
    """The kernels a net takes on the card, forward and backward, by its
    shape alone: "wgmma" (``csrc/fused_pe_mlp_fwd.cu``,
    ``csrc/fused_pe_mlp_bwd.cu``) for every net those take (all presets'
    PE proposal nets at 64 wide); "wide" (the PE variant of
    ``csrc/fused_mlp_fwd.cu``, ``csrc/fused_pe_mlp_wide_bwd.cu`` and the
    PE variant of ``csrc/fused_mlp_bwd.cu``) for x [N, 3], at most 64
    encoding columns, 2 or 3 layers and at most 16 outputs, hidden layers
    padded to 128 or 256 (``mlp_hidden_pad``), whose backward with weight
    gradients fits a block's shared memory at one stage and one set of
    operand tiles (the 128-wide nets of ``cropnerf-mxu-q``; not a 3-layer
    net 256 wide); else "stream" (``csrc/fused_mlp_stream.cu``) for 1 to
    32 layers with every width up to 512 and the encoding up to 256.
    Raises ValueError for a wider or deeper net, which no kernel takes."""
    if pe_mlp_kernels_take(dim, num_freqs, widths):
        return "wgmma"
    enc = dim * (1 + 2 * num_freqs)
    if (dim == PE_MLP_DIM and enc <= PE_MLP_ENC and len(widths) in (2, 3)
            and 1 <= widths[-1] <= PE_MLP_OUT):
        hw = mlp_hidden_pad(enc, widths)
        if hw and _least_bwd_smem(enc, widths[-1], len(widths), hw,
                                  pe=True) <= MAX_SMEM_BYTES:
            return "wide"
    if stream_takes(enc, widths, dim, num_freqs):
        return "stream"
    raise ValueError(
        f"fused_pe_mlp: no kernel takes x [N, {dim}], F={num_freqs} "
        f"({enc} encoding columns) -> {list(widths)} (at most {MAX_LAYERS} "
        f"layers, each at most {STREAM_MAX_WIDTH} wide, the encoding at most "
        f"{MAX_PE_IN}, F at most {MAX_FREQS})")


def _pe_route(x, wbs, num_freqs) -> str:
    return pe_mlp_fwd_route(x.shape[1], num_freqs,
                            [w.shape[1] for w in wbs[0::2]])


def _wide(wbs) -> bool:
    """Whether a net the wgmma kernels take is on the "wide" route: a
    hidden layer over 64."""
    return any(w.shape[1] > PE_MLP_HIDDEN for w in wbs[0:-2:2])


def pe_mlp_images(wbs: Sequence[torch.Tensor], backward: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgmma kernels' weights (``common.weight_images``): for the
    64-wide nets every layer's rows padded to 64, the encoding's too; for
    the "wide" route ``fused_mlp.mlp_images``' layout (the encoding's rows
    padded to 16, hidden layers to 128 or 256)."""
    if _wide(wbs):
        return mlp_images(wbs, backward)
    return weight_images(wbs, PE_MLP_HIDDEN, backward)


@functools.lru_cache(maxsize=None)
def _pe_mlp_bwd_lib():
    lib = build.load("fused_pe_mlp_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cropnerf_pe_mlp_bwd_layout.argtypes = [
        i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.cropnerf_pe_mlp_bwd.argtypes = [vp] * 5 + [i32] * 3 + [
        ctypes.c_longlong, i32] + [vp] * 5
    for f in ("cropnerf_pe_mlp_bwd_layout", "cropnerf_pe_mlp_bwd"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _pe_mlp_fwd_lib():
    lib = build.load("fused_pe_mlp_fwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cropnerf_pe_mlp_fwd_layout.argtypes = [
        i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.cropnerf_pe_mlp_fwd.argtypes = [vp] * 4 + [i32] * 3 + [
        ctypes.c_longlong, i32, vp]
    for f in ("cropnerf_pe_mlp_fwd_layout", "cropnerf_pe_mlp_fwd"):
        getattr(lib, f).restype = ctypes.c_int
    return lib


def _layout(name, layout_fn, n_layers) -> list:
    """The sizes a kernel's C layout function reports for a depth."""
    sizes = (ctypes.c_longlong * 6)()
    if layout_fn(n_layers, sizes):
        raise ValueError(f"{name}: {n_layers} layers")
    return list(sizes)


@functools.lru_cache(maxsize=None)
def _pe_mlp_fwd_layout(n_layers: int) -> Tuple[int, int]:
    """(elements of the forward images, of the biases) of the forward
    kernel's layout for a depth."""
    fwd_elems, n_bias, _, wgs = _layout(
        "fused_pe_mlp", _pe_mlp_fwd_lib().cropnerf_pe_mlp_fwd_layout,
        n_layers)[:4]
    if wgs != PE_MLP_FWD_WGS:
        raise RuntimeError("fused_pe_mlp_fwd: the kernel's warpgroups do "
                           "not match the plan")
    return fwd_elems, n_bias


def _pe_mlp_fwd_launch(x, wbs, num_freqs, img, bias) -> torch.Tensor:
    """One launch of the forward kernel of the net's route on CUDA tensors
    (none for N = 0), ``csrc/fused_pe_mlp_fwd.cu`` or the PE variant of
    ``csrc/fused_mlp_fwd.cu``, on ``pe_mlp_images``, with or without the
    backward's half: the [N, Dout] float32 output."""
    device, n = x.device, x.shape[0]
    if _wide(wbs):
        out = wgmma_forward("fused_pe_mlp", x, wbs, img, bias, num_freqs)
        if n:
            fused_pe_mlp.launches += 1
        return out
    lib = _pe_mlp_fwd_lib()
    fwd_elems, n_bias = _pe_mlp_fwd_layout(len(wbs) // 2)
    check_images("fused_pe_mlp", img, bias, (fwd_elems, 2 * fwd_elems),
                  n_bias)
    out = torch.empty((n, wbs[-2].shape[1]), dtype=torch.float32,
                      device=device)
    if n == 0:
        return out
    blocks = pe_mlp_blocks(n, sm_count(device), PE_MLP_FWD_WGS)
    with torch.cuda.device(device):
        err = lib.cropnerf_pe_mlp_fwd(
            x.data_ptr(), out.data_ptr(), img.data_ptr(), bias.data_ptr(),
            len(wbs) // 2, num_freqs, out.shape[1], n, blocks,
            stream_ptr(device))
    if err:
        raise RuntimeError(f"fused_pe_mlp kernel launch failed: cudaError "
                           f"{err}")
    fused_pe_mlp.launches += 1
    return out


def fused_pe_mlp_stream(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                        num_freqs: int) -> torch.Tensor:
    """The "stream" route of ``pe_mlp_fwd_route`` on CUDA tensors: K5's
    variant of ``csrc/fused_mlp_stream.cu``'s forward (one launch, none for
    N = 0)."""
    out = stream_forward("fused_pe_mlp", x, wbs, num_freqs)
    if x.shape[0]:
        fused_pe_mlp_stream.launches += 1
    return out


@torch.no_grad()
def fused_pe_mlp_stream_bwd(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                            num_freqs: int, g: torch.Tensor,
                            need_dx: bool = True, need_dw: bool = True):
    """The "stream" route's backward on CUDA tensors (K5's variant of
    ``csrc/fused_mlp_stream.cu``'s): as ``fused_pe_mlp_bwd``."""
    out = stream_backward("fused_pe_mlp_bwd", x, wbs, g, need_dx, need_dw,
                          num_freqs)
    if x.shape[0]:
        fused_pe_mlp_stream_bwd.launches += 1
    return out


@torch.no_grad()
def fused_pe_mlp_bwd(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                     num_freqs: int, g: torch.Tensor, need_dx: bool = True,
                     need_dw: bool = True, images=None):
    """The backward kernel of ``fused_pe_mlp`` on CUDA tensors: the
    cotangent g [N, Dout] → (dx [N, dim] or None, [dW0, db0, ...] in the
    shapes of ``wbs`` or None) in float32.  It recomputes the forward.
    ``images``: the (image, bias) of ``pe_mlp_images`` for ``wbs`` where
    the caller has them (the forward's; none on the stream route), else
    built here.  On the net's route (``pe_mlp_fwd_route``)."""
    _check_pe_mlp(x, wbs, num_freqs)
    device = check_kernel_call("fused_pe_mlp_bwd", [x, g, *wbs],
                               torch.bfloat16)
    n, n_layers = x.shape[0], len(wbs) // 2
    check_rows("g", g, n=n, cols=wbs[-2].shape[1])
    if not (need_dx or need_dw):
        raise ValueError("fused_pe_mlp_bwd: nothing asked for")
    route = _pe_route(x, wbs, num_freqs)
    if route == "stream":
        return fused_pe_mlp_stream_bwd(x, wbs, num_freqs, g, need_dx, need_dw)
    if route == "wide":
        out = wgmma_backward("fused_pe_mlp_bwd", x, wbs, g, need_dx, need_dw,
                             images, num_freqs)
        if n:
            fused_pe_mlp_bwd.launches += 1
        return out
    lib = _pe_mlp_bwd_lib()
    img_elems, n_bias, total_w, total_b, _, wgs = _layout(
        "fused_pe_mlp_bwd", lib.cropnerf_pe_mlp_bwd_layout, n_layers)
    img, bias = images if images is not None else pe_mlp_images(wbs)
    check_images("fused_pe_mlp_bwd", img, bias, (img_elems,), n_bias)
    if wgs != PE_MLP_WGS:
        raise RuntimeError("fused_pe_mlp_bwd: the kernel's warpgroups do "
                           "not match the plan")
    blocks = pe_mlp_blocks(n, sm_count(device), PE_MLP_WGS)
    dx = torch.empty_like(x) if need_dx else None
    ptrs = [None] * 4
    if need_dw:
        dw = torch.zeros((total_w,), dtype=torch.float32, device=device)
        db = torch.zeros((total_b,), dtype=torch.float32, device=device)
        wpart = torch.empty((blocks * total_w,), dtype=torch.float32,
                            device=device)
        bpart = torch.empty((blocks * total_b,), dtype=torch.float32,
                            device=device)
        ptrs = [t.data_ptr() for t in (wpart, bpart, dw, db)]
    if n:
        with torch.cuda.device(device):
            err = lib.cropnerf_pe_mlp_bwd(
                x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
                img.data_ptr(), bias.data_ptr(), n_layers, num_freqs,
                g.shape[1], n, blocks, *ptrs, stream_ptr(device))
        if err:
            raise RuntimeError(f"fused_pe_mlp_bwd kernel launch failed: "
                               f"cudaError {err}")
        fused_pe_mlp_bwd.launches += 1
    dwbs = None
    if need_dw:
        dwbs = []
        for l in range(n_layers):
            w, b = wbs[2 * l], wbs[2 * l + 1]
            width = PE_MLP_OUT if l == n_layers - 1 else PE_MLP_HIDDEN
            w_off, b_off = l * PE_MLP_HIDDEN * PE_MLP_HIDDEN, l * PE_MLP_HIDDEN
            dwbs.append(dw[w_off:w_off + PE_MLP_HIDDEN * width]
                        .reshape(PE_MLP_HIDDEN, width)[:w.shape[0], :w.shape[1]])
            dwbs.append(db[b_off:b_off + b.numel()].reshape(b.shape))
    return dx, dwbs


class _FusedPeMlp(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient, run only
    for the gradients asked for (no dx where x needs none, no weight
    gradients where the weights need none).  Saves x and the weights, as
    the JAX ``_plain_fwd`` does, and on the wgmma routes the weight images
    the forward built, which the backward reads too: all through
    ``save_for_backward``, so that a checkpoint's hooks drop the images
    with the rest and its replay builds them again."""

    @staticmethod
    def forward(ctx, x, num_freqs, *wbs):
        ctx.num_freqs, ctx.n_wbs = num_freqs, len(wbs)
        if _pe_route(x, wbs, num_freqs) == "stream":
            ctx.save_for_backward(x, *wbs)
            return fused_pe_mlp_stream(x, wbs, num_freqs)
        images = pe_mlp_images(wbs)
        ctx.save_for_backward(x, *wbs, *images)
        return _pe_mlp_fwd_launch(x, wbs, num_freqs, *images)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        wbs, images = rest[:ctx.n_wbs], tuple(rest[ctx.n_wbs:]) or None
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[2:])
        dx, dwbs = fused_pe_mlp_bwd(x, wbs, ctx.num_freqs, g.contiguous(),
                                    need_dx, need_dw, images)
        return (dx, None, *(dwbs if need_dw else [None] * len(wbs)))


def _fused_pe_mlp_card(x, wbs, num_freqs) -> torch.Tensor:
    """``fused_pe_mlp`` on checked CUDA tensors.  Where a graph is
    recorded, the autograd function above; else the forward kernel that
    ``pe_mlp_fwd_route`` picks, the wgmma kernels on the forward half of
    the weight images alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *wbs)):
        return _FusedPeMlp.apply(x, num_freqs, *wbs)
    if _pe_route(x, wbs, num_freqs) == "stream":
        return fused_pe_mlp_stream(x, wbs, num_freqs)
    return _pe_mlp_fwd_launch(x, wbs, num_freqs,
                              *pe_mlp_images(wbs, backward=False))


def fused_pe_mlp(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                 num_freqs: int,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, dim] float32 (encoder domain, unit*2-1) → NeRF encoding with
    ``num_freqs`` frequencies → relu MLP wbs = [W0, b0, W1, b1, ...] (W
    [in, out], b [1, out]; linear last layer) → [N, Dout] float32,
    differentiable in x and the weights.  On the card the kernels are the
    ones ``pe_mlp_fwd_route`` picks by shape, each route with its
    backward."""
    _check_pe_mlp(x, wbs, num_freqs)
    if x.device.type == "cpu":
        return fused_pe_mlp_plain(x, wbs, num_freqs, compute_dtype)
    check_kernel_call("fused_pe_mlp", [x, *wbs], compute_dtype)
    return _fused_pe_mlp_card(x, wbs, num_freqs)


fused_pe_density.launches = 0
fused_pe_density_bwd.launches = 0
fused_pe_nerf.launches = 0
fused_pe_nerf_bwd.launches = 0
fused_pe_mlp.launches = 0
fused_pe_mlp_stream.launches = 0
fused_pe_mlp_bwd.launches = 0
fused_pe_mlp_stream_bwd.launches = 0
