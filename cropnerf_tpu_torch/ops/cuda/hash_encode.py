"""Multiresolution hash-grid encoding on the card, forward and backward
(counterpart of ``cropnerf_tpu/ops/pallas/hash_encode.py`` and of the
custom VJP in ``cropnerf_tpu/ops/hashgrid.py``).

``hash_encode`` launches the CUDA kernel ``csrc/hash_encode.cu`` and is
differentiable.  Its forward gives a thread one position at a group of
levels (:func:`level_group`) and stores each block's results whole
sectors at a time; its backward is the kernels' backward, one pass over the
positions per level that adds the table gradient when the table needs one
(the levels of :func:`private_levels` summed in shared memory first) and
gathers each level's share of the position gradient when the positions
need one, then sums those shares in level order.  The table is
[rows, 2] float32 with each level at a row offset, so the dense and the
packed layout both come here
(``ops/hashgrid.py`` computes the offsets and holds the plain version).
The kernels are float32 throughout and take no compute dtype; they accept
only CUDA tensors and raise on anything else: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .common import MAX_SMEM_BYTES, c_ints, check_rows, stream_ptr

FEATURES = 2          # csrc/hash_encode.cu reads rows as float2


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("hash_encode")
    lib.cropnerf_hash_encode_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.cropnerf_hash_encode_fwd.restype = ctypes.c_int
    lib.cropnerf_hash_encode_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.cropnerf_hash_encode_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _levels(device: torch.device, resolutions: Tuple[int, ...],
            offsets: Tuple[int, ...], dense: Tuple[bool, ...]) -> torch.Tensor:
    """int64 [L, 3] (first row, resolution, dense flag) on the card, made
    once per layout."""
    rows = [[o, r, int(d)] for o, r, d in zip(offsets, resolutions, dense)]
    return torch.tensor(rows, dtype=torch.int64, device=device)


MAX_GROUP = 16        # csrc/hash_encode.cu MAX_GROUP: levels a thread


def level_group(n_levels: int) -> int:
    """Levels one thread of the forward encodes at its position: the whole
    row of up to 8 levels (the proposal nets' 5: 40 contiguous bytes), else
    4 (the field's 16: one 32-byte sector of the output per position, and
    a group's hashed levels, 16 MB of table, held in the 50 MB L2)."""
    return n_levels if n_levels <= 8 else 4


def private_levels(resolutions: Sequence[int], dense: Sequence[bool],
                   smem_bytes: int = MAX_SMEM_BYTES) -> Tuple[int, ...]:
    """The levels whose table gradient the backward sums in shared memory
    first: the dense ones whose (res+1)^3 rows of 8 bytes fit the shared
    memory one block can take."""
    return tuple(l for l, (r, d) in enumerate(zip(resolutions, dense))
                 if d and (r + 1) ** 3 * 8 <= smem_bytes)


@functools.lru_cache(maxsize=64)
def _level_ids(device: torch.device, resolutions: Tuple[int, ...],
               dense: Tuple[bool, ...]) -> torch.Tensor:
    """int32 [L] on the card: the privatised levels, then the others."""
    priv = private_levels(resolutions, dense)
    rest = [l for l in range(len(resolutions)) if l not in priv]
    return torch.tensor([*priv, *rest], dtype=torch.int32, device=device)


def _check(name: str, table2d: torch.Tensor, pos: torch.Tensor,
           resolutions: Sequence[int], table_size: int) -> torch.device:
    """The kernels' device check: CUDA, one device, float32 and contiguous,
    F = 2 rows aligned for float2 loads, T a power of two."""
    device = pos.device
    if device.type != "cuda" or table2d.device != device:
        raise ValueError(f"{name}: expected the table and positions on one "
                         f"CUDA device, got {table2d.device} and {device}")
    check_rows("positions", pos, cols=3)
    check_rows("table", table2d, cols=FEATURES)
    if table2d.data_ptr() % 8:
        raise ValueError(f"{name}: table rows are not 8-byte aligned")
    if table_size < 1 or table_size & (table_size - 1):
        raise ValueError(f"{name}: table size {table_size} is not a power "
                         "of two")
    if not 1 <= len(resolutions) <= 65535:
        raise ValueError(f"{name}: {len(resolutions)} levels")
    return device


def hash_encode_fwd(table2d: torch.Tensor, pos: torch.Tensor,
                    resolutions: Tuple[int, ...], offsets: Tuple[int, ...],
                    dense: Tuple[bool, ...], table_size: int) -> torch.Tensor:
    """The forward kernel: pos [N, 3] → features [N, L·2] float32, a
    thread per position and :func:`level_group` levels."""
    device = _check("hash_encode", table2d, pos, resolutions, table_size)
    L, n = len(resolutions), pos.shape[0]
    out = torch.empty((n, L * FEATURES), dtype=torch.float32, device=device)
    if n == 0:
        return out
    levels = _levels(device, resolutions, offsets, dense)
    with torch.cuda.device(device):
        err = _lib().cropnerf_hash_encode_fwd(
            pos.data_ptr(), table2d.data_ptr(), levels.data_ptr(), L,
            level_group(L), table_size - 1, out.data_ptr(), n,
            stream_ptr(device))
    if err:
        raise RuntimeError(f"hash_encode kernel launch failed: cudaError {err}")
    hash_encode.launches += 1
    return out


@torch.no_grad()
def hash_encode_bwd(table2d: torch.Tensor, pos: torch.Tensor,
                    grad: torch.Tensor, resolutions: Tuple[int, ...],
                    offsets: Tuple[int, ...], dense: Tuple[bool, ...],
                    table_size: int, need_dpos: bool = True,
                    need_dtable: bool = True
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The backward kernels: the cotangent [N, L·2] of the features →
    (d table [rows, 2] or None, d pos [N, 3] or None) in float32.  One
    call counts one launch, whatever number of kernels it starts."""
    device = _check("hash_encode_bwd", table2d, pos, resolutions, table_size)
    L, n = len(resolutions), pos.shape[0]
    check_rows("grad", grad, n=n, cols=L * FEATURES)
    if grad.device != device:
        raise ValueError(f"hash_encode_bwd: grad on {grad.device}")
    dtable = torch.zeros_like(table2d) if need_dtable else None
    dpos = torch.empty_like(pos) if need_dpos else None
    if n == 0 or not (need_dtable or need_dpos):
        return dtable, dpos
    levels = _levels(device, resolutions, offsets, dense)
    priv = private_levels(resolutions, dense)
    # each level's share of dpos, summed by the last kernel
    dlev = (torch.empty((L, n, 3), dtype=torch.float32, device=device)
            if need_dpos else None)
    with torch.cuda.device(device):
        err = _lib().cropnerf_hash_encode_bwd(
            pos.data_ptr(), table2d.data_ptr(), grad.data_ptr(),
            levels.data_ptr(), L, table_size - 1,
            dtable.data_ptr() if need_dtable else None,
            dpos.data_ptr() if need_dpos else None,
            dlev.data_ptr() if need_dpos else None, n,
            _level_ids(device, resolutions, dense).data_ptr(), len(priv),
            c_ints(priv), c_ints([(resolutions[l] + 1) ** 3 for l in priv]),
            stream_ptr(device))
    if err:
        raise RuntimeError(f"hash_encode_bwd kernel launch failed: "
                           f"cudaError {err}")
    hash_encode_bwd.launches += 1
    return dtable, dpos


class _HashEncode(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient; saves only
    the table and the positions, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, table2d, pos, layout):
        ctx.save_for_backward(table2d, pos)
        ctx.layout = layout
        return hash_encode_fwd(table2d, pos, *layout)

    @staticmethod
    def backward(ctx, g):
        table2d, pos = ctx.saved_tensors
        dtable, dpos = hash_encode_bwd(table2d, pos, g.contiguous(),
                                       *ctx.layout,
                                       need_dpos=ctx.needs_input_grad[1],
                                       need_dtable=ctx.needs_input_grad[0])
        return dtable, dpos, None


def hash_encode(table2d: torch.Tensor, pos: torch.Tensor,
                resolutions: Tuple[int, ...], offsets: Tuple[int, ...],
                dense: Tuple[bool, ...], table_size: int) -> torch.Tensor:
    """pos [N, 3] float32 in [0, 1] → features [N, L·2] float32 through
    the table [rows, 2]: level l's rows start at ``offsets[l]``, and it
    indexes densely where ``dense[l]``, else by hash & (table_size − 1).
    Differentiable in the table and the positions."""
    return _HashEncode.apply(table2d, pos,
                             (resolutions, offsets, dense, table_size))


hash_encode.launches = 0
hash_encode_bwd.launches = 0
