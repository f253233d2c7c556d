"""Training losses: RGB MSE, semantic BCE, interlevel (proposal), distortion
and the camera-opt regulariser (counterpart of
``cropnerf_tpu/ops/losses.py``, same forms: the gather-free sum form of the
mipnerf360 ``outer`` measure and the O(n) cumulative-sum distortion)."""
from __future__ import annotations

from typing import List, Optional

import torch

_EPS = torch.finfo(torch.float32).eps


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    err = (pred - target) ** 2
    if mask is not None:
        denom = mask.sum().clamp_min(1.0) * err.shape[-1]
        return (err * mask[..., None]).sum() / denom
    return err.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, mean reduction."""
    per = (logits.clamp_min(0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    if mask is not None:
        denom = mask.sum().clamp_min(1.0) * (per.numel() / mask.numel())
        m = mask.reshape(mask.shape + (1,) * (per.dim() - mask.dim()))
        return (per * m).sum() / denom
    return per.mean()


def _outer_measure(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """Total env weight intersecting each query bin (mipnerf360 ``outer``),
    as masked sums linear in y1: query edges t0 [R, N], env edges t1 and
    weights y1 [R, M], all in s-space and ascending."""
    lo_mask = t1_starts[..., None, 1:] <= t0_starts[..., :, None]  # [R,N,M-1]
    cy1_lo = torch.where(lo_mask, y1[..., None, :-1], 0.0).sum(dim=-1)
    hi_mask = t1_ends[..., None, :-1] <= t0_ends[..., :, None]     # [R,N,M-1]
    cy1_hi = y1[..., :1] + torch.where(hi_mask, y1[..., None, 1:],
                                       0.0).sum(dim=-1)
    return cy1_hi - cy1_lo


def interlevel_loss(weights_list: List[torch.Tensor],
                    sdist_list: List[torch.Tensor]) -> torch.Tensor:
    """Proposal supervision (mipnerf360 ``lossfun_outer``), the only gradient
    path into the proposal nets; the final level is detached."""
    c = sdist_list[-1].detach()
    w = weights_list[-1].detach()
    loss = 0.0
    for sdist, wp in zip(sdist_list[:-1], weights_list[:-1]):
        w_outer = _outer_measure(c[..., :-1], c[..., 1:],
                                 sdist[..., :-1], sdist[..., 1:], wp)
        loss = loss + ((w - w_outer).clamp_min(0.0) ** 2 / (w + _EPS)).mean()
    return loss


def distortion_loss(weights: torch.Tensor, sdist: torch.Tensor) -> torch.Tensor:
    """mipnerf360 distortion on the final level, O(n) form:
    2 Σ_i w_i (m_i W_i^< - S_i^<) + (1/3) Σ_i w_i² (t_{i+1} - t_i), with
    W^< and S^< the exclusive prefix sums of w and w·m."""
    m = 0.5 * (sdist[..., 1:] + sdist[..., :-1])
    dt = sdist[..., 1:] - sdist[..., :-1]
    wm = weights * m
    w_cum = torch.cumsum(weights, dim=-1) - weights
    wm_cum = torch.cumsum(wm, dim=-1) - wm
    loss_bi = 2.0 * (weights * (m * w_cum - wm_cum)).sum(dim=-1)
    loss_uni = (weights ** 2 * dt).sum(dim=-1) / 3.0
    return (loss_bi + loss_uni).mean()


def camera_opt_regularizer(pose_adjustment: torch.Tensor,
                           trans_penalty: float = 1e-2,
                           rot_penalty: float = 1e-3) -> torch.Tensor:
    """L2 penalty on the SE(3) tangent deltas; the norm has a 1e-12 floor
    so its gradient is finite at the zero init."""
    trans = torch.sqrt((pose_adjustment[:, :3] ** 2).sum(dim=-1) + 1e-12).mean()
    rot = torch.sqrt((pose_adjustment[:, 3:] ** 2).sum(dim=-1) + 1e-12).mean()
    return trans * trans_penalty + rot * rot_penalty
