"""Image-quality metrics (counterpart of ``cropnerf_tpu/ops/metrics.py``):
PSNR, SSIM and binary IoU, the trainer's eval metrics.  LPIPS is
``ops/lpips.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """SSIM with an 11x11 Gaussian window (torchmetrics defaults), VALID
    depthwise filtering in float32.

    pred/target: [H, W, C] in [0, data_range].
    """
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    C = pred.shape[-1]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)
    kern = kern.expand(C, 1, kernel_size, kernel_size)              # [C,1,k,k]

    def filt(img):
        x = img.float().permute(2, 0, 1)[None]                      # [1,C,H,W]
        return F.conv2d(x, kern, groups=C)[0]                       # [C,h,w]

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = filt(pred * pred) - mu_pp
    sig_t = filt(target * target) - mu_tt
    sig_pt = filt(pred * target) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return (num / den).mean()


def binary_iou(pred: torch.Tensor, target: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """Jaccard index on {0,1} masks after thresholding probabilities; 1.0
    when the union is empty."""
    p = (pred >= threshold).float()
    t = (target >= threshold).float()
    inter = (p * t).sum()
    union = torch.maximum(p, t).sum()
    return torch.where(union > 0, inter / union.clamp_min(1.0),
                       torch.ones((), device=pred.device))
