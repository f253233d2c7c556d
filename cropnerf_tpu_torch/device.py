"""Device placement for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point places its work on.

    ``cuda`` is the default; when no card is visible this raises instead of
    running on the CPU, which only an explicit ``device="cpu"`` selects.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the port runs on 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev
