"""Volume-rendering compositors (counterpart of
``cropnerf_tpu/ops/render.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def render_weights(density: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = (1 - exp(-σ_i δ_i)) · exp(-Σ_{j<i} σ_j δ_j), density/deltas
    [R, S] → weights [R, S]."""
    tau = density * deltas
    alpha = 1.0 - torch.exp(-tau)
    accum = torch.cumsum(tau, dim=-1)
    trans = torch.exp(-(accum - tau))
    return alpha * trans


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Σ_i w_i v_i along the sample axis; weights [R, S], values [R, S, C]."""
    return (weights[..., None] * values).sum(dim=-2)


def render_rgb(weights: torch.Tensor, rgb: torch.Tensor,
               background: str = "last_sample",
               background_color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite RGB over a "last_sample", "black" or "color" background."""
    comp = accumulate(weights, rgb)
    acc = weights.sum(dim=-1, keepdim=True)
    if background == "last_sample":
        bg = rgb[..., -1, :]
    elif background == "black":
        bg = torch.zeros_like(comp)
    elif background == "color":
        if background_color is None:
            raise ValueError("background='color' needs background_color")
        bg = background_color.expand_as(comp)
    else:
        raise ValueError(background)
    return comp + (1.0 - acc) * bg


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """Opacity per ray, [R, 1]."""
    return weights.sum(dim=-1, keepdim=True)


def render_depth_median(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The step at which the cumulative weight first reaches 0.5, or the
    last step if it never does; [R, 1]."""
    crossed = torch.cumsum(weights, dim=-1) >= 0.5
    # argmax takes no bool; on {0,1} integers it returns the first maximum
    idx = crossed.to(torch.int32).argmax(dim=-1)
    idx = torch.where(crossed.any(dim=-1), idx, steps.shape[-1] - 1)
    return torch.gather(steps, -1, idx[..., None])


def render_depth_expected(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Expected depth Σwt / Σw, [R, 1]."""
    acc = weights.sum(dim=-1, keepdim=True)
    d = (weights * steps).sum(dim=-1, keepdim=True)
    return d / acc.clamp_min(1e-10)


def render_semantics(weights: torch.Tensor, semantics: torch.Tensor) -> torch.Tensor:
    """Accumulated per-sample semantic logits, [R, C]."""
    return accumulate(weights, semantics)
