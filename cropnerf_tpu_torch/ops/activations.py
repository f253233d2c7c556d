"""Numerically guarded activations (counterpart of
``cropnerf_tpu/ops/activations.py``)."""
from __future__ import annotations

import torch

_TRUNC = 15.0


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with its input clamped to ±15, as the JAX package clamps it
    (bf16 exp overflows past ~88 and inf would poison the transmittance
    scan).  Forward only; the ``g * y`` backward comes with training."""
    return torch.exp(x.clamp(-_TRUNC, _TRUNC))
