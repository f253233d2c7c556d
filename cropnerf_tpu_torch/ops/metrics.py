"""Image-quality metrics (counterpart of ``cropnerf_tpu/ops/metrics.py``):
PSNR.  SSIM and IoU come with the trainer's full evaluation."""
from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))
