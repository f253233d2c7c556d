"""Fused positional-encoding NeRF field (counterpart of
``cropnerf_tpu/ops/pallas/fused_pe_field.py``).

``fused_pe_density`` (trunk only) and ``fused_pe_nerf`` (trunk + colour +
semantic heads) launch the CUDA kernel ``csrc/fused_pe_field.cu`` for
tensors on the card and compute ``fused_pe_density_plain`` /
``fused_pe_nerf_plain``, the same arithmetic in plain PyTorch, for tensors
on the CPU.  The kernel replaces the Pallas ``_fwd_kernel`` and
``_mega_fwd_kernel``.  It is compute-bound on an H100 (see the source
note): every intermediate stays in shared memory, the weights stream from
L2.  The ragged tail of N is masked in the kernel; there is no fallback.

Both are differentiable.  On the card their backwards are
``fused_pe_nerf_bwd`` and ``fused_pe_density_bwd``, the CUDA kernel
``csrc/fused_pe_field_bwd.cu`` with and without the heads (replacing
``_mega_bwd_kernel`` and ``_bwd_kernel``), which recomputes the forward;
``fused_pe_density_bwd`` computes only the gradients autograd asks for
(dx alone in the BayesRays pass).  On the CPU autograd runs through the
plain versions.

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
from .common import (MAX_SMEM_BYTES, c_ints, check_kernel_call, check_rows,
                     pack_layers, pad16, stream_ptr, unpack_layers)


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
    cd = compute_dtype
    t = fused_pe_density_plain(x, base_wbs, top_wbs, num_freqs, cd)
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
    return t, c.float(), sm.float()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fused_pe_field")
    lib.cropnerf_pe_field_fwd.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.cropnerf_pe_field_fwd.restype = ctypes.c_int
    lib.cropnerf_pe_field_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    lib.cropnerf_pe_field_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = build.load("fused_pe_field_bwd")
    lib.cropnerf_pe_field_bwd.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.cropnerf_pe_field_bwd.restype = ctypes.c_int
    lib.cropnerf_pe_field_bwd_sizes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.cropnerf_pe_field_bwd_sizes.restype = ctypes.c_int
    lib.cropnerf_pe_field_bwd_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
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
    """Dynamic shared memory one block of the kernel takes for ``meta``
    (-1 where the kernel rejects the layout)."""
    return _lib().cropnerf_pe_field_smem_bytes(c_ints(meta), len(meta),
                                               int(heads))


def _launch(name, x, extras, outs, wbuf, bbuf, meta, heads, device):
    lib = _lib()
    smem = smem_bytes(meta, heads)
    if smem < 0:
        raise ValueError(f"{name}: the kernel rejects this network layout")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    t, rgb, sem = outs
    with torch.cuda.device(device):
        err = lib.cropnerf_pe_field_fwd(
            x.data_ptr(), extras.data_ptr() if heads else None, t.data_ptr(),
            rgb.data_ptr() if heads else None,
            sem.data_ptr() if heads else None, wbuf.data_ptr(),
            bbuf.data_ptr(), c_ints(meta), len(meta), x.shape[0], heads,
            stream_ptr(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _density_forward(x, base_wbs, top_wbs, num_freqs, device):
    wbuf, bbuf, meta = pack_pe_field(x.shape[1], num_freqs, base_wbs,
                                     top_wbs, device=device)
    t = torch.empty((x.shape[0], top_wbs[-2].shape[1]), dtype=torch.float32,
                    device=device)
    if x.shape[0] == 0:
        return t
    _launch("fused_pe_density", x, None, (t, None, None), wbuf, bbuf, meta,
            0, device)
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
    _launch("fused_pe_nerf", x, extras, outs, wbuf, bbuf, meta, 1, device)
    fused_pe_nerf.launches += 1
    return outs


def bwd_smem_bytes(meta, heads: bool = True) -> int:
    """Dynamic shared memory one block of the backward's tile kernel takes
    (-1 where the kernel rejects the layout)."""
    return _bwd_lib().cropnerf_pe_field_bwd_smem_bytes(c_ints(meta),
                                                       len(meta), int(heads))


def _bwd_launch(name, x, extras, cots, dx, dex, wbuf, bbuf, meta, heads,
                pass_sem, need_dw, device):
    """One launch of the backward kernel: the workspace and partials, then
    (dw, db) packed, or None without weight gradients."""
    lib = _bwd_lib()
    n = x.shape[0]
    sizes = (ctypes.c_longlong * 5)()
    if lib.cropnerf_pe_field_bwd_sizes(c_ints(meta), len(meta), n,
                                       int(heads), int(need_dw), sizes):
        raise ValueError(f"{name}: the kernel rejects this layout")
    smem = bwd_smem_bytes(meta, heads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    ws_elems, n_bpart, n_wpart, total_w, total_b = list(sizes)
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
        ws = torch.empty((ws_elems,), dtype=torch.bfloat16, device=device)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            err = lib.cropnerf_pe_field_bwd(
                x.data_ptr(), ptr(extras), *[ptr(c) for c in cots], ptr(dx),
                ptr(dex), wbuf.data_ptr(), bbuf.data_ptr(), c_ints(meta),
                len(meta), n, int(heads), int(pass_sem), ws.data_ptr(),
                *ptrs, stream_ptr(device))
        if err:
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


fused_pe_density.launches = 0
fused_pe_density_bwd.launches = 0
fused_pe_nerf.launches = 0
fused_pe_nerf_bwd.launches = 0
