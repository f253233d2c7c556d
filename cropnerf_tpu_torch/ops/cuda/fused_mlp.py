"""Fused relu MLP, forward and backward (counterpart of
``cropnerf_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp`` launches the CUDA kernels of ``csrc/fused_mlp.cu`` for a
tensor on the card and computes ``fused_mlp_plain``, the same arithmetic in
plain PyTorch, for a tensor on the CPU (autograd through it is the CPU
backward).  The kernels replace the Pallas ``_fwd_kernel`` and
``_bwd_kernel``; they run the vanilla field's semantic and colour heads on
the export path and in the BayesRays pass.  They are memory-bound on an
H100 (see the source note).  On the card the backward
(``fused_mlp_bwd``) recomputes the forward from x and the weights, as the
JAX custom VJP saves only ``(x, wbs)``, and computes only the gradients
autograd asks for: dx alone when no weight needs one.  The ragged tail of
N is masked in the kernels; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..mlp import mm_f32acc
from . import build
from .common import (MAX_SMEM_BYTES, c_ints, check_kernel_call, check_rows,
                     pack_layers, pad16, stream_ptr, unpack_layers)


def fused_mlp_plain(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, Din] → [N, Dout] f32 through wbs = [W0, b0, W1, b1, ...]:
    operands rounded to ``compute_dtype``, f32 accumulation, relu and a
    rounding after every hidden layer."""
    n_layers = len(wbs) // 2
    h = x
    for i in range(n_layers):
        h = mm_f32acc(h, wbs[2 * i], compute_dtype) + wbs[2 * i + 1]
        if i < n_layers - 1:
            h = torch.relu(h).to(compute_dtype)
    return h.float()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("fused_mlp")
    lib.cropnerf_fused_mlp_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.cropnerf_fused_mlp_fwd.restype = ctypes.c_int
    lib.cropnerf_fused_mlp_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cropnerf_fused_mlp_smem_bytes.restype = ctypes.c_int
    lib.cropnerf_fused_mlp_bwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_void_p] * 5
    lib.cropnerf_fused_mlp_bwd.restype = ctypes.c_int
    lib.cropnerf_fused_mlp_bwd_sizes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.cropnerf_fused_mlp_bwd_sizes.restype = ctypes.c_int
    lib.cropnerf_fused_mlp_bwd_smem_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cropnerf_fused_mlp_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def _layers(wbs: Sequence[torch.Tensor]):
    return [([(wbs[2 * i], pad16(wbs[2 * i].shape[0]))], wbs[2 * i + 1])
            for i in range(len(wbs) // 2)]


def pack_mlp(din: int, wbs: Sequence[torch.Tensor],
             device: torch.device | str = "cpu"):
    """(bf16 weights, f32 biases, meta ints) as the kernels take them."""
    layers = _layers(wbs)
    wbuf, bbuf, descs = pack_layers(layers, torch.device(device))
    hmax = max([pad16(din)] + [pad16(w.shape[1]) for w in wbs[0::2]])
    return wbuf, bbuf, [din, pad16(din), wbs[-2].shape[1], len(layers),
                        hmax] + descs


def smem_bytes(meta) -> int:
    """Dynamic shared memory one block of the kernel takes for ``meta``."""
    return _lib().cropnerf_fused_mlp_smem_bytes(c_ints(meta), len(meta))


def bwd_smem_bytes(meta) -> int:
    """Dynamic shared memory one block of the backward takes for ``meta``
    (-1 where the kernel rejects the layout)."""
    return _lib().cropnerf_fused_mlp_bwd_smem_bytes(c_ints(meta), len(meta))


def _forward(x, wbs, device):
    n_rows = x.shape[0]
    wbuf, bbuf, meta = pack_mlp(x.shape[1], wbs, device)
    out = torch.empty((n_rows, wbs[-2].shape[1]), dtype=torch.float32,
                      device=device)
    if n_rows == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().cropnerf_fused_mlp_fwd(
            x.data_ptr(), out.data_ptr(), wbuf.data_ptr(), bbuf.data_ptr(),
            c_ints(meta), len(meta), n_rows, stream_ptr(device))
    if err:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


@torch.no_grad()
def fused_mlp_bwd(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                  g: torch.Tensor, need_dx: bool = True,
                  need_dw: bool = True):
    """The backward kernel of ``fused_mlp`` on CUDA tensors: the cotangent
    g [N, Dout] → (dx [N, Din] or None, [dW0, db0, dW1, db1, ...] in the
    shapes of ``wbs`` or None) in float32.  It recomputes the forward."""
    device = check_kernel_call("fused_mlp_bwd", [x, g, *wbs], torch.bfloat16)
    n = x.shape[0]
    check_rows("g", g, n=n, cols=wbs[-2].shape[1])
    wbuf, bbuf, meta = pack_mlp(x.shape[1], wbs, device)
    lib = _lib()
    sizes = (ctypes.c_longlong * 4)()
    if lib.cropnerf_fused_mlp_bwd_sizes(c_ints(meta), len(meta), n,
                                        int(need_dw), sizes):
        raise ValueError("fused_mlp_bwd: the kernel rejects this layout")
    smem = bwd_smem_bytes(meta)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_mlp_bwd: needs {smem} B of shared memory "
                         f"per block, more than {MAX_SMEM_BYTES}")
    n_wpart, n_bpart, total_w, total_b = list(sizes)
    dx = torch.empty_like(x) if need_dx else None
    ptrs = [None] * 4
    if need_dw:
        dw = torch.zeros((total_w,), dtype=torch.float32, device=device)
        db = torch.zeros((total_b,), dtype=torch.float32, device=device)
        wpart = torch.zeros((n_wpart,), dtype=torch.float32, device=device)
        bpart = torch.zeros((n_bpart,), dtype=torch.float32, device=device)
        ptrs = [t.data_ptr() for t in (wpart, bpart, dw, db)]
    if n:
        with torch.cuda.device(device):
            err = lib.cropnerf_fused_mlp_bwd(
                x.data_ptr(), g.data_ptr(),
                dx.data_ptr() if need_dx else None, wbuf.data_ptr(),
                bbuf.data_ptr(), c_ints(meta), len(meta), n, *ptrs,
                stream_ptr(device))
        if err:
            raise RuntimeError(f"fused_mlp_bwd kernel launch failed: "
                               f"cudaError {err}")
        fused_mlp_bwd.launches += 1
    dwbs = None
    if need_dw:
        dwbs = [t for ws, db_l in unpack_layers(_layers(wbs), dw, db,
                                                meta[5:])
                for t in (*ws, db_l)]
    return dx, dwbs


class _FusedMlp(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient.  Saves only
    x and the weights, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, *wbs):
        ctx.save_for_backward(x, *wbs)
        return _forward(x, wbs, x.device)

    @staticmethod
    def backward(ctx, g):
        x, *wbs = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[1:])
        dx, dwbs = fused_mlp_bwd(x, wbs, g.contiguous(), need_dx, need_dw)
        return (dx, *(dwbs if need_dw else [None] * len(wbs)))


def fused_mlp(x: torch.Tensor, wbs: Sequence[torch.Tensor],
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, Din] float32 → [N, Dout] float32 through the relu MLP
    wbs = [W0, b0, W1, b1, ...] (W [in, out], b [1, out] or [out]),
    differentiable in x and the weights."""
    if len(wbs) < 2 or len(wbs) % 2:
        raise ValueError("wbs must be [W0, b0, W1, b1, ...]")
    check_rows("x", x)
    din = x.shape[1]
    k = din
    for w in wbs[0::2]:
        if w.dim() != 2 or w.shape[0] != k:
            raise ValueError(f"weight {tuple(w.shape)} does not take width {k}")
        k = w.shape[1]
    if x.device.type == "cpu":
        return fused_mlp_plain(x, wbs, compute_dtype)
    check_kernel_call("fused_mlp", [x, *wbs], compute_dtype)
    return _FusedMlp.apply(x, *wbs)


fused_mlp.launches = 0
fused_mlp_bwd.launches = 0
