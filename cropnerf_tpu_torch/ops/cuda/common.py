"""Argument checks and weight packing shared by the kernel wrappers.

The PE field's kernels (K1, K2) take every weight of the field in one
bf16 buffer and every bias in one f32 buffer (``pack_layers``), and return
their weight gradients in that layout, as the stream route's backward
(``mlp_plan.py``) does.  Each matrix is zero-padded to multiples of 16 in
both dims; a layer whose input is a concatenation of two activations (the
skip layer, the colour head's layer 0) stacks the two padded row blocks.
Each layer is described by five ints: (weight offset, bias offset, padded
K, padded N, rows taken from the first input).  The resident-weight wgmma
MLP kernels (K3 and K5) take ``weight_images`` instead and run
``persistent_blocks`` blocks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

# one dense layer: ([(weight [k_i, n], padded k_i), ...], bias [n] or [1, n])
Layer = Tuple[List[Tuple[torch.Tensor, int]], torch.Tensor]

MAX_WIDTH = 1024           # the widest padded layer of the PE field's tile
                           # kernels (K1, K2): two passes of two warpgroups
STREAM_MAX_WIDTH = 512     # the widest input and layer of the stream route (K3,
                           # K5): two warpgroups' 256-column halves
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


# csrc/wgmma_mlp.cuh: the widths the wgmma MLP kernels pad a net's hidden
# layers (the PE nets; the heads' nets to a multiple of it) and its output
# to; the PE nets' encoding columns at most and x's coordinates
WGMMA_HIDDEN, WGMMA_OUT = 64, 16
PE_ENC, PE_DIM = 64, 3


@functools.lru_cache(maxsize=None)
def _image_gather(shapes: tuple, k0: int, backward: bool,
                  device: torch.device, hidden: int = WGMMA_HIDDEN
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each element of ``weight_images`` for weights and biases of
    ``shapes`` (hidden layers padded to ``hidden``) comes from in their
    flattened concatenation with one zero appended (the padding), on
    ``device``: (image indices, bias indices, that zero)."""
    n_layers, pad = len(shapes) // 2, sum(int(np.prod(s)) for s in shapes)
    at = torch.arange(pad).split([int(np.prod(s)) for s in shapes])
    fwd, bwd, bias = [], [], []
    for l in range(n_layers):
        w, b = at[2 * l].reshape(shapes[2 * l]), at[2 * l + 1]
        k = k0 if l == 0 else hidden
        width = WGMMA_OUT if l == n_layers - 1 else hidden
        wp = torch.full((k, width), pad)
        wp[:w.shape[0], :w.shape[1]] = w
        fwd.append(wp.reshape(k // 8, 8, width).permute(0, 2, 1).reshape(-1))
        bwd.append(wp.reshape(k, width // 8, 8).permute(1, 0, 2).reshape(-1))
        bias.append(torch.nn.functional.pad(b, (0, width - b.numel()),
                                            value=pad))
    img = torch.cat(fwd + (bwd if backward else []))
    return (img.to(device), torch.cat(bias).to(device),
            torch.zeros(1, device=device))


def weight_images(wbs: Sequence[torch.Tensor], k0: int,
                  backward: bool = True, hidden: int = WGMMA_HIDDEN
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgmma MLP kernels' weights, on the weights' device: (bf16
    images, f32 biases).  Every layer's weight is zero-padded to [k0, H]
    (layer 0), [H, H] (hidden) or [H, 16] (the last), H = ``hidden`` (64,
    or the heads' 128 and 256), and laid out as a
    wgmma B operand in K-major core matrices: first all forward images
    (element (k, n) of a [K, width] weight at (k/8)·width·8 + n·8 + k%8;
    all a forward kernel reads), then, with ``backward``, all
    input-gradient images of Wᵀ (element (n, k) at (n/8)·K·8 + k·8 + n%8).
    The biases are padded alike, layer after layer.  Four operations on the
    card: one concatenation and gathers at indices cached per shape and
    device."""
    img_at, bias_at, zero = _image_gather(
        tuple(tuple(t.shape) for t in wbs), k0, backward, wbs[0].device,
        hidden)
    flat = torch.cat([t.reshape(-1) for t in wbs] + [zero]).float()
    return (flat.index_select(0, img_at).to(torch.bfloat16),
            flat.index_select(0, bias_at))


def check_images(name, img, bias, img_elems, n_bias) -> None:
    """Raises unless ``weight_images``' (img, bias) have sizes a kernel's
    layout reports (``img_elems``: the sizes it takes)."""
    if img.numel() not in img_elems or bias.numel() != n_bias:
        raise RuntimeError(f"{name}: the weight images do not match the "
                           "kernel's layout")


def persistent_blocks(n_rows: int, sm_count: int, wgs: int) -> int:
    """Persistent blocks of a wgmma MLP kernel of ``wgs`` warpgroups a
    block: one per SM, fewer where the 64-row tiles do not give each of a
    block's warpgroups one.  Warpgroup w of block b takes tiles wgs·b + w,
    then every wgs·blocks-th after it."""
    tiles = -(-n_rows // 64)
    return max(1, min(sm_count, -(-tiles // wgs)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def c_ints(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
