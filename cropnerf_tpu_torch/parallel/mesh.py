"""The port's mesh and its sharding helpers (counterpart of
``cropnerf_tpu/parallel/mesh.py``).

JAX drives every local device from one process over a 1-D ``data`` mesh.
PyTorch runs one process per rank under ``torch.distributed``, so the
port's mesh is the process group: a record of this rank, the world size,
the rank's device and the groups its collectives go through.  The model is
small, so the only scaling axis is rays (and, for inference, the chunks,
batches and dispatches of a run): parameters are replicated, and the
training step all-reduces its gradient explicitly (``train/step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group.

    ``group`` carries the gradient all-reduce (NCCL when each rank has its
    own card, else gloo); ``cpu_group`` (gloo) carries barriers and the
    host objects that :func:`gather_in_order` moves.  ``local_size`` ranks
    run on this rank's node."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    local_size: int = 1
    group: Any = None
    cpu_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def nodes(self) -> int:
        return max(1, self.size // max(1, self.local_size))


def main_rank(mesh: Optional[Mesh]) -> bool:
    """True on rank 0, and without a mesh."""
    return mesh is None or mesh.rank == 0


_warned_unsharded: set = set()


def warn_unsharded(site: str, n: int, mesh_size: int) -> None:
    """One-time notice when a dispatch falls back to unsharded because the
    batch does not divide the mesh — a user asking for --multichip should
    never silently get a single-device run."""
    key = (site, n, mesh_size)
    if key not in _warned_unsharded:
        _warned_unsharded.add(key)
        print(f"[{site}] NOTE: batch of {n} rays does not divide the "
              f"{mesh_size}-device mesh — this dispatch runs UNSHARDED "
              "(pick a batch size divisible by the device count to shard "
              "it)", flush=True)


def pad_to_multiple(n: int, devices: int) -> int:
    """Smallest multiple of ``devices`` >= n (ray batches must divide the
    mesh evenly for even sharding)."""
    return ((n + devices - 1) // devices) * devices


def gather_in_order(n_items: int, compute: Callable,
                    mesh: Optional[Mesh] = None,
                    prepare: Optional[Callable[[int], Any]] = None,
                    should_stop: Optional[Callable[[], bool]] = None
                    ) -> Iterator[Tuple[int, Any]]:
    """Items 0 .. n_items-1 split over the ranks, gathered in order.

    Rank r computes items r, r+N, r+2N, ...; after each round of N items
    the results cross to rank 0 (host objects, over ``cpu_group``), which
    yields ``(i, result)`` in item order; the other ranks yield nothing.
    ``prepare(i)``, when given, runs on every rank for every item, in
    order, and its value is ``compute``'s second argument: a draw from a
    generator shared by the ranks stays in step with a one-rank run.
    ``should_stop()`` is asked on rank 0 after each round (after each item
    without a mesh), and its answer, sent to every rank, ends the loop;
    items a round computed past the stop are still yielded.  Every rank
    must exhaust the iterator."""
    def call(i, prepared):
        return compute(i) if prepare is None else compute(i, prepared)

    if mesh is None or mesh.size == 1:
        for i in range(n_items):
            yield i, call(i, prepare(i) if prepare is not None else None)
            if should_stop is not None and should_stop():
                return
        return
    import torch.distributed as dist
    n = mesh.size
    for first in range(0, n_items, n):
        mine = None
        for i in range(first, min(first + n, n_items)):
            prepared = prepare(i) if prepare is not None else None
            if i % n == mesh.rank:
                mine = call(i, prepared)
        gathered = [None] * n if mesh.is_main else None
        dist.gather_object(mine, gathered, dst=0, group=mesh.cpu_group)
        if mesh.is_main:
            for i in range(first, min(first + n, n_items)):
                yield i, gathered[i - first]
        if should_stop is not None:
            flag = [should_stop() if mesh.is_main else None]
            dist.broadcast_object_list(flag, src=0, group=mesh.cpu_group)
            if flag[0]:
                return
