"""Fused relu MLP, forward (counterpart of
``cropnerf_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp`` launches the CUDA kernel ``csrc/fused_mlp.cu`` for a tensor
on the card and computes ``fused_mlp_plain``, the same arithmetic in plain
PyTorch, for a tensor on the CPU.  The kernel replaces the Pallas
``_fwd_kernel``; on the export path it runs the vanilla field's semantic
and colour heads.  It is memory-bound on an H100 (see the source note), so
it reads x once and writes y once.  The ragged tail of N is masked in the
kernel; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..mlp import mm_f32acc
from . import build
from .common import (c_ints, check_kernel_call, check_rows, pack_layers,
                     pad16, stream_ptr)


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
    return lib


def pack_mlp(din: int, wbs: Sequence[torch.Tensor],
             device: torch.device | str = "cpu"):
    """(bf16 weights, f32 biases, meta ints) as the kernel takes them."""
    layers = [([(wbs[2 * i], pad16(wbs[2 * i].shape[0]))], wbs[2 * i + 1])
              for i in range(len(wbs) // 2)]
    wbuf, bbuf, descs = pack_layers(layers, torch.device(device))
    hmax = max([pad16(din)] + [pad16(w.shape[1]) for w in wbs[0::2]])
    return wbuf, bbuf, [din, pad16(din), wbs[-2].shape[1], len(layers),
                        hmax] + descs


def smem_bytes(meta) -> int:
    """Dynamic shared memory one block of the kernel takes for ``meta``."""
    return _lib().cropnerf_fused_mlp_smem_bytes(c_ints(meta), len(meta))


def fused_mlp(x: torch.Tensor, wbs: Sequence[torch.Tensor],
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, Din] float32 → [N, Dout] float32 through the relu MLP
    wbs = [W0, b0, W1, b1, ...] (W [in, out], b [1, out] or [out])."""
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
    device = check_kernel_call("fused_mlp", [x, *wbs], compute_dtype,
                               no_backward="slice 4, the remaining kernels")

    n_rows = x.shape[0]
    wbuf, bbuf, meta = pack_mlp(din, wbs, device)
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


fused_mlp.launches = 0
