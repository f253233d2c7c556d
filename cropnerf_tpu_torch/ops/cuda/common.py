"""Argument checks and weight packing shared by the kernel wrappers.

The kernels take every weight of a network in one bf16 buffer and every
bias in one f32 buffer.  Each matrix is zero-padded to multiples of 16 in
both dims (the wmma tile); a layer whose input is a concatenation of two
activations (the skip layer, the colour head's layer 0) stacks the two
padded row blocks.  Each layer is described to the kernel by five ints:
(weight offset, bias offset, padded K, padded N, rows taken from the first
input).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

# one dense layer: ([(weight [k_i, n], padded k_i), ...], bias [n] or [1, n])
Layer = Tuple[List[Tuple[torch.Tensor, int]], torch.Tensor]

MAX_WIDTH = 256            # csrc/fused_layers.cuh MAX_WIDTH
MAX_SMEM_BYTES = 232_448   # per-block dynamic shared memory on Hopper


def pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def pack_layers(layers: Sequence[Layer], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """(bf16 weight buffer, f32 bias buffer, 5 ints per layer)."""
    w_parts, b_parts, descs = [], [], []
    w_off = b_off = 0
    for parts, bias in layers:
        n = bias.numel()
        n_pad = pad16(n)
        if n_pad > MAX_WIDTH:
            raise ValueError(f"layer width {n} exceeds the kernels' "
                             f"{MAX_WIDTH}")
        k_total = 0
        for w, k_pad in parts:
            if w.dim() != 2 or w.shape[1] != n or w.shape[0] > k_pad:
                raise ValueError(f"weight {tuple(w.shape)} does not fit "
                                 f"[{k_pad}, {n}]")
            blk = torch.zeros((k_pad, n_pad), dtype=torch.bfloat16,
                              device=device)
            blk[:w.shape[0], :n] = w
            w_parts.append(blk.reshape(-1))
            k_total += k_pad
        b = torch.zeros((n_pad,), dtype=torch.float32, device=device)
        b[:n] = bias.reshape(-1)
        b_parts.append(b)
        descs += [w_off, b_off, k_total, n_pad, parts[0][1]]
        w_off += k_total * n_pad
        b_off += n_pad
    return torch.cat(w_parts), torch.cat(b_parts), descs


def check_rows(name: str, t: torch.Tensor, n: int | None = None,
               cols: int | None = None) -> None:
    """A row-major float32 [N, cols] input."""
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 [N, C] tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"{name} has {t.shape[1]} columns, expected {cols}")


def check_kernel_call(name: str, tensors: Sequence[torch.Tensor],
                      compute_dtype: torch.dtype) -> torch.device:
    """The checks every CUDA launch makes: one CUDA device, bf16 compute."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel computes in bf16; "
                         f"{compute_dtype} runs only on the CPU plain path")
    return device


def unpack_layers(layers: Sequence[Layer], dwbuf: torch.Tensor,
                  dbbuf: torch.Tensor, descs: Sequence[int]
                  ) -> List[Tuple[List[torch.Tensor], torch.Tensor]]:
    """Inverse of :func:`pack_layers` for gradients: the packed f32 weight
    and bias gradient buffers → per layer ([gradient of each weight part in
    its unpadded shape], gradient of the bias in its shape)."""
    out = []
    for li, (parts, bias) in enumerate(layers):
        w_off, b_off, _, n_pad, _ = descs[5 * li:5 * li + 5]
        n = bias.numel()
        grads, row = [], 0
        for w, k_pad in parts:
            blk = dwbuf[w_off + row * n_pad:w_off + (row + k_pad) * n_pad]
            grads.append(blk.reshape(k_pad, n_pad)[:w.shape[0], :n])
            row += k_pad
        out.append((grads, dbbuf[b_off:b_off + n].reshape(bias.shape)))
    return out


def c_ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
