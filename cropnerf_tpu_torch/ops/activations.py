"""Numerically guarded activations (counterpart of
``cropnerf_tpu/ops/activations.py``)."""
from __future__ import annotations

import torch

_TRUNC = 15.0


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.exp(x.clamp(-_TRUNC, _TRUNC))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with its input clamped to ±15, as the JAX package clamps it
    (bf16 exp overflows past ~88 and inf would poison the transmittance
    scan).  Its gradient is ``g * y``, the JAX custom VJP: unlike the
    autograd of the clamp, it does not vanish where |x| > 15."""
    return _TruncExp.apply(x)
