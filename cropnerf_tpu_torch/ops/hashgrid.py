"""Multiresolution hash-grid encoding (counterpart of
``cropnerf_tpu/ops/hashgrid.py``, tiny-cuda-nn's ``HashGrid``).

A level of resolution ``res`` indexes its corner lattice densely where
(res+1)^3 fits the table (tcnn semantics, ``hash_mode="auto"``) and
hashes with the Teschner primes otherwise; ``hash_mode="hash"`` hashes
every level.  The table is either the dense [L, T, F] layout or the packed
[sum(rows_l), F] layout of the presets, whose dense levels keep only their
(res+1)^3 rows (:func:`level_row_counts`).  Both are rows of F features at
per-level row offsets (:func:`_level_offsets`), so one kernel serves both.

:func:`hashgrid_encode` sends a tensor on the card to the CUDA kernels
(``ops/cuda/hash_encode.py``: the forward gather and blend, and a
backward that scatters the table gradient and returns the analytic
position gradient) and computes :func:`hashgrid_encode_plain`, the same
arithmetic in plain PyTorch, for a tensor on the CPU.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from ..device import resolve_device
from .cuda.hash_encode import hash_encode as hash_encode_cuda

# Spatial hashing primes from Instant-NGP (Teschner et al.)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def level_resolutions(num_levels: int, min_res: int,
                      max_res: int) -> Tuple[int, ...]:
    """Per-level grid resolutions N_l = floor(min_res * b^l)."""
    if num_levels == 1:
        return (min_res,)
    growth = math.exp((math.log(max_res) - math.log(min_res))
                      / (num_levels - 1))
    return tuple(int(math.floor(min_res * growth ** l + 1e-9))
                 for l in range(num_levels))


def level_uses_dense(res: int, table_size: int) -> bool:
    """A level indexes its (res+1)^3 corner lattice densely when it fits
    the table, and hashes otherwise."""
    return (res + 1) ** 3 <= table_size


def level_row_counts(resolutions: Sequence[int], table_size: int,
                     hash_mode: str = "auto") -> Tuple[int, ...]:
    """Rows per level in the packed layout: (res+1)^3 for a dense level,
    the full table for a hashed one."""
    return tuple(
        ((res + 1) ** 3
         if hash_mode == "auto" and level_uses_dense(res, table_size)
         else table_size)
        for res in resolutions)


def _level_offsets(resolutions: Sequence[int], table_size: int,
                   hash_mode: str, packed: bool) -> Tuple[List[int], int]:
    """(first row of each level, total rows) of the packed or the dense
    layout."""
    if packed:
        offs, off = [], 0
        for rows in level_row_counts(resolutions, table_size, hash_mode):
            offs.append(off)
            off += rows
        return offs, off
    L = len(resolutions)
    return [l * table_size for l in range(L)], L * table_size


def _uniform(shape, generator: torch.Generator, scale: float,
             device: torch.device | str) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((2.0 * u - 1.0) * scale).to(resolve_device(device))


def hashgrid_init(num_levels: int, features_per_level: int,
                  log2_hashmap_size: int, generator: torch.Generator,
                  scale: float = 1e-4,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """Dense [L, 2^log2_hashmap_size, F] float32 table, uniform in
    ±``scale`` (NGP's 1e-4 default)."""
    return _uniform((num_levels, 2 ** log2_hashmap_size, features_per_level),
                    generator, scale, device)


def hashgrid_init_packed(resolutions: Sequence[int], features_per_level: int,
                         log2_hashmap_size: int, generator: torch.Generator,
                         scale: float = 1e-4, hash_mode: str = "auto",
                         device: torch.device | str = "cuda") -> torch.Tensor:
    """Packed [sum(rows_l), F] float32 table, uniform in ±``scale``."""
    rows = sum(level_row_counts(resolutions, 2 ** log2_hashmap_size,
                                hash_mode))
    return _uniform((rows, features_per_level), generator, scale, device)


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
           table_size: int) -> torch.Tensor:
    """The uint32 Teschner hash, wrap-around included, in int64: each
    product is cut to 32 bits before the XOR and the ``% T``."""
    h = (((ix & _U32) * _PRIMES[0]) & _U32) \
        ^ (((iy & _U32) * _PRIMES[1]) & _U32) \
        ^ (((iz & _U32) * _PRIMES[2]) & _U32)
    return h % table_size


def _table_layout(table: torch.Tensor, resolutions: Sequence[int],
                  hash_mode: str, table_size: int | None):
    """(table as [rows, F], row offsets, dense flags, table size)."""
    if table.dim() == 2:
        if table_size is None:
            raise ValueError("the packed layout needs table_size")
        offsets, total = _level_offsets(resolutions, table_size, hash_mode,
                                        packed=True)
        if total != table.shape[0]:
            raise ValueError(f"packed table has {table.shape[0]} rows, the "
                             f"levels need {total}")
    else:
        L, T, _ = table.shape
        if len(resolutions) != L:
            raise ValueError(f"{len(resolutions)} resolutions for {L} levels")
        table_size = table_size or T
        offsets, _ = _level_offsets(resolutions, T, hash_mode, packed=False)
    dense = [hash_mode == "auto" and level_uses_dense(r, table_size)
             for r in resolutions]
    return table.reshape(-1, table.shape[-1]), offsets, dense, table_size


def hashgrid_encode_plain(table: torch.Tensor, positions: torch.Tensor,
                          resolutions: Sequence[int],
                          hash_mode: str = "auto",
                          table_size: int | None = None,
                          cell_pack: bool = False) -> torch.Tensor:
    """positions [..., 3] in [0, 1] → features [..., L·F] float32, in
    plain PyTorch (the JAX ``hashgrid_encode_ref``).

    Per level: scaled = pos·res, frac = scaled − floor(scaled); a dense
    level clips the base corner to [0, res−1] but keeps frac from the
    unclipped floor (at pos = 1, frac is 0 and the level returns corner
    res−1 with weight 1).  The 8 corners are blended in order 0..7 with
    weight (tx·ty)·tz.  Autograd
    gives the table gradient through the row gather and the position
    gradient through frac.  ``cell_pack`` is accepted and ignored: in the
    JAX package it only changes how dense levels are gathered, not the
    values."""
    del cell_pack
    table2d, offsets, dense, table_size = _table_layout(
        table, resolutions, hash_mode, table_size)
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3).float()
    outs = []
    for l, res in enumerate(resolutions):
        scaled = pos * res
        basef = torch.floor(scaled)
        frac = scaled - basef
        base = basef.long()
        if dense[l]:
            base = base.clamp(0, res - 1)
            side = res + 1
        feats = torch.zeros((pos.shape[0], table2d.shape[1]),
                            dtype=torch.float32, device=pos.device)
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            if dense[l]:
                idx = ((base[:, 0] + dx) * side * side
                       + (base[:, 1] + dy) * side + (base[:, 2] + dz))
            else:
                idx = _hash3(base[:, 0] + dx, base[:, 1] + dy,
                             base[:, 2] + dz, table_size)
            w = ((frac[:, 0] if dx else 1.0 - frac[:, 0])
                 * (frac[:, 1] if dy else 1.0 - frac[:, 1])
                 * (frac[:, 2] if dz else 1.0 - frac[:, 2]))
            feats = feats + table2d[offsets[l] + idx] * w[:, None]
        outs.append(feats)
    return torch.cat(outs, dim=-1).reshape(*batch_shape, -1)


def hashgrid_encode(table: torch.Tensor, positions: torch.Tensor,
                    resolutions: Sequence[int], hash_mode: str = "auto",
                    table_size: int | None = None,
                    cell_pack: bool = False) -> torch.Tensor:
    """positions [..., 3] in [0, 1] → features [..., L·F] float32,
    differentiable in the table and the positions.

    On the card: the ``hash_encode`` CUDA kernels, for either layout
    (F = 2, T a power of two); on the CPU: :func:`hashgrid_encode_plain`.
    ``cell_pack`` is accepted and ignored (value-identical in the JAX
    package)."""
    if positions.device.type == "cpu":
        return hashgrid_encode_plain(table, positions, resolutions,
                                     hash_mode, table_size, cell_pack)
    table2d, offsets, dense, table_size = _table_layout(
        table, resolutions, hash_mode, table_size)
    batch_shape = positions.shape[:-1]
    out = hash_encode_cuda(table2d, positions.reshape(-1, 3).contiguous(),
                           tuple(resolutions), tuple(offsets), tuple(dense),
                           table_size)
    return out.reshape(*batch_shape, out.shape[-1])
