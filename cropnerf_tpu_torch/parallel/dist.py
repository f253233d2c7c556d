"""Process-group initialisation and synchronisation (counterpart of
``cropnerf_tpu/parallel/dist.py``).

One process per rank, as the reference's DDP runs (world_size/local_rank
threaded through its pipeline, ``dist.barrier``).  A launcher such as
``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; manual setups
pass the address, the world size and the rank.

Placement: rank r takes ``cuda:(LOCAL_RANK % device_count)``.  When every
rank of a node has its own card the backend is NCCL; when ranks share a
card (more ranks on a node than cards) or run on the CPU it is gloo, since
NCCL refuses two ranks on one card.  Gloo reduces and broadcasts CUDA
tensors by staging them through the host; the port's other collectives
move host objects over a gloo group in any case.  Nothing falls back: a
rank that cannot reach its device raises, and so does a collective that
fails.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional

import torch

from ..device import resolve_device
from .mesh import Mesh

_MESH: Optional[Mesh] = None


def launcher_world_size() -> int:
    """The world size a launcher set in the environment (1: none)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(device_type: str, local_size: int,
                   device_count: int) -> str:
    """NCCL when each of the node's ``local_size`` ranks has its own card,
    else gloo."""
    if device_type == "cuda" and local_size <= device_count:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         platform: Optional[str] = None,
                         timeout_s: float = 1800.0) -> Mesh:
    """Join the process group and return this rank's :class:`Mesh`.

    Without arguments the launcher's environment gives the address, the
    world size and the rank; ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` set them by hand.  ``platform``
    ``cpu`` (or ``CROPNERF_PLATFORM=cpu``) runs the rank on the CPU; else it
    takes its card, and a machine with no card raises."""
    import torch.distributed as dist
    global _MESH
    if coordinator_address is not None:
        host, port = coordinator_address.rsplit(":", 1)
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port,
                          WORLD_SIZE=str(num_processes),
                          RANK=str(process_id))
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    device = resolve_device(platform or os.environ.get("CROPNERF_PLATFORM")
                            or "cuda")
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(device)
    backend = choose_backend(device.type, local_size, count)
    timeout = timedelta(seconds=timeout_s)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=size,
                            timeout=timeout, **kwargs)
    group = dist.group.WORLD
    cpu_group = (group if backend == "gloo"
                 else dist.new_group(backend="gloo", timeout=timeout))
    _MESH = Mesh(rank=rank, size=size, device=device, backend=backend,
                 local_size=local_size, group=group, cpu_group=cpu_group)
    return _MESH


def current_mesh() -> Optional[Mesh]:
    """The mesh :func:`initialize_multihost` made in this process, or
    None."""
    return _MESH


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def barrier(name: str = "barrier", mesh: Optional[Mesh] = None) -> None:
    """Every rank waits here (≙ dist.barrier, fruit_pipeline.py:121); a
    no-op without a group.  ``name`` labels a failure."""
    import torch.distributed as dist
    mesh = mesh or _MESH
    if mesh is None or mesh.size == 1:
        return
    try:
        dist.barrier(group=mesh.cpu_group)
    except Exception as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {mesh.rank}"
                           ) from e


def process_info(mesh: Optional[Mesh] = None) -> dict:
    """This process's place, with the JAX function's keys: each rank is a
    process driving one device."""
    mesh = mesh or _MESH
    local = (torch.cuda.device_count() if torch.cuda.is_available() else 1)
    if mesh is None:
        return {"process_index": 0, "process_count": 1,
                "local_device_count": local, "global_device_count": 1}
    return {"process_index": mesh.rank, "process_count": mesh.size,
            "local_device_count": local, "global_device_count": mesh.size}


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None
                      ) -> slice:
    """The slice of a globally-indexed ray batch this rank should produce
    (per-rank input pipelines feed only their local shard)."""
    mesh = mesh or _MESH
    count, index = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    per = global_batch // count
    return slice(index * per, (index + 1) * per)
