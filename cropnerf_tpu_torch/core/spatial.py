"""Spatial warps: scene contraction and AABB normalisation
(counterpart of ``cropnerf_tpu/core/spatial.py``)."""
from __future__ import annotations

import torch


def contract_inf(x: torch.Tensor) -> torch.Tensor:
    """L-inf scene contraction: identity inside the unit box, maps all of
    space into [-2, 2]^3 outside."""
    mag = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    contracted = (2.0 - 1.0 / mag) * (x / mag)
    return torch.where(mag <= 1.0, x, contracted)


def contracted_to_unit(x: torch.Tensor) -> torch.Tensor:
    """Map contracted space [-2, 2] to [0, 1]."""
    return (contract_inf(x) + 2.0) / 4.0


def aabb_to_unit(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Normalise world positions into [0, 1] by an AABB [2, 3]."""
    lo, hi = aabb[0], aabb[1]
    return (x - lo) / (hi - lo)


def unit_selector(x_unit: torch.Tensor) -> torch.Tensor:
    """{0,1} mask of positions inside the unit cube."""
    inside = ((x_unit >= 0.0) & (x_unit <= 1.0)).all(dim=-1)
    return inside.to(x_unit.dtype)
