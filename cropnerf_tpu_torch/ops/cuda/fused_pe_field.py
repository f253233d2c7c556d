"""Fused positional-encoding NeRF field, forward (counterpart of
``cropnerf_tpu/ops/pallas/fused_pe_field.py``).

``fused_pe_density`` (trunk only) and ``fused_pe_nerf`` (trunk + colour +
semantic heads) launch the CUDA kernel ``csrc/fused_pe_field.cu`` for
tensors on the card and compute ``fused_pe_density_plain`` /
``fused_pe_nerf_plain``, the same arithmetic in plain PyTorch, for tensors
on the CPU.  The kernel replaces the Pallas ``_fwd_kernel`` and
``_mega_fwd_kernel``.  It is compute-bound on an H100 (see the source
note): every intermediate stays in shared memory, the weights stream from
L2.  The ragged tail of N is masked in the kernel; there is no fallback.

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
                     pack_layers, pad16, stream_ptr)


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
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch trunk + heads (≙ the JAX ``_mega_ref``)."""
    cd = compute_dtype
    t = fused_pe_density_plain(x, base_wbs, top_wbs, num_freqs, cd)
    tb = t.to(cd)
    ex = extras.to(cd)
    c = (mm_f32acc(tb, color_wbs[0], cd) + mm_f32acc(ex, color_wbs[1], cd)
         + color_wbs[2])
    for i in range(1, (len(color_wbs) - 1) // 2):
        c = torch.relu(c).to(cd)
        c = mm_f32acc(c, color_wbs[2 * i + 1], cd) + color_wbs[2 * i + 2]
    sm = mm_f32acc(tb, sem_wbs[0], cd) + sem_wbs[1]
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


def _pairs(wbs: Sequence[torch.Tensor]):
    return [(wbs[2 * i], wbs[2 * i + 1]) for i in range(len(wbs) // 2)]


def pack_pe_field(dim: int, num_freqs: int, base_wbs, top_wbs,
                  color_wbs=None, sem_wbs=None, de: int = 0,
                  device: torch.device | str = "cpu"):
    """(bf16 weights, f32 biases, meta ints) as the kernel takes them.
    Heads are packed when ``color_wbs``/``sem_wbs`` are given."""
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
    wbuf, bbuf, descs = pack_layers(layers, torch.device(device))
    hmax = max(descs[3::5])
    meta = [dim, num_freqs, enc_cols, enc_pad, de, ex_pad,
            len(base_wbs) // 2, len(top_wbs) // 2, n_color, n_sem,
            t_cols, rgb_cols, sem_cols, hmax] + descs
    return wbuf, bbuf, meta


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


def fused_pe_density(x: torch.Tensor, base_wbs: Sequence[torch.Tensor],
                     top_wbs: Sequence[torch.Tensor], num_freqs: int,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """x [N, dim] float32 (encoder domain, unit*2-1) → t [N, Dout] float32.

    base_wbs/top_wbs = [W0, b0, W1, b1, ...]; W_top0 is the skip layer
    [H + dim(1+2F), H_top]."""
    check_rows("x", x)
    if x.device.type == "cpu":
        return fused_pe_density_plain(x, base_wbs, top_wbs, num_freqs,
                                      compute_dtype)
    device = check_kernel_call("fused_pe_density",
                               [x, *base_wbs, *top_wbs], compute_dtype)
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


def fused_pe_nerf(x: torch.Tensor, extras: torch.Tensor,
                  base_wbs: Sequence[torch.Tensor],
                  top_wbs: Sequence[torch.Tensor],
                  color_wbs: Sequence[torch.Tensor],
                  sem_wbs: Sequence[torch.Tensor], num_freqs: int,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trunk + colour head + semantic head in one kernel.

    x [N, dim] float32; extras [N, De] float32 (direction encoding ‖
    appearance row per sample).  color_wbs = [WcT_pad (1+G, Hc), WcE
    (De, Hc), bc0, Wc1, bc1, ...], sem_wbs = [WsT_pad (1+G, Hs), bs0, Ws1,
    bs1, ...], head layer-0 weights with a zero top row.  Returns
    (t [N, 1+G], rgb_raw [N, 3], sem_raw [N, C]) in float32."""
    check_rows("x", x)
    check_rows("extras", extras, n=x.shape[0])
    if x.device.type == "cpu":
        return fused_pe_nerf_plain(x, extras, base_wbs, top_wbs, color_wbs,
                                   sem_wbs, num_freqs, compute_dtype)
    device = check_kernel_call(
        "fused_pe_nerf",
        [x, extras, *base_wbs, *top_wbs, *color_wbs, *sem_wbs], compute_dtype)
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


fused_pe_density.launches = 0
fused_pe_nerf.launches = 0
