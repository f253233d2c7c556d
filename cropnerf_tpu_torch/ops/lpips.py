"""LPIPS perceptual metric (eval-only, optional; counterpart of
``cropnerf_tpu/ops/lpips.py``).

The same computation as the JAX module, on the same weights: input in
[0, 1] → scaled to [-1, 1] → per-channel shift/scale → VGG16 convs (3×3,
SAME padding, ReLU); at each tap (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3) unit-normalise the channels, squared difference, per-channel
linear calibration, spatial mean, then a 2×2 max pool; the taps summed.

Weights come from ``CROPNERF_LPIPS_WEIGHTS``: a ``.npz`` written by
``tools/convert_lpips_weights.py`` (conv kernels ``convN_w`` [kh, kw, cin,
cout] (HWIO) and biases ``convN_b``, ``linN`` [c] at each tap's conv
index), or the sentinel ``uncalibrated``, which draws the JAX module's
deterministic random weights from the same ``np.random.RandomState``.
Without weights the metric is unavailable (``lpips`` returns None).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_DEFAULT_WEIGHTS: Optional[dict] = None
_DEFAULT_LOADED = False


def load_weights(path: Path) -> Optional[dict]:
    """The ``.npz`` at ``path`` as float32 CPU tensors in its own (HWIO)
    layout, or None when the file is absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in data.items()}


# LPIPS tap widths for the five VGG16 stages (relu1_2..relu5_3) and the
# number of convs per stage — the structure uncalibrated_weights mirrors
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def uncalibrated_weights(width_mult: float = 0.25, seed: int = 0) -> dict:
    """Deterministic random VGG16-structure weights (He-init convs, positive
    per-channel lin heads) at ``width_mult`` of the real channel widths,
    drawn in the JAX module's order from the same RandomState, so both
    packages compute the same uncalibrated metric."""
    rng = np.random.RandomState(seed)
    out = {}
    cin = 3
    conv_idx = 0
    for width, n_convs in _VGG_STAGES:
        cout = max(8, int(width * width_mult))
        for i in range(n_convs):
            std = float(np.sqrt(2.0 / (3 * 3 * cin)))
            out[f"conv{conv_idx}_w"] = torch.from_numpy(
                rng.randn(3, 3, cin, cout).astype(np.float32) * std)
            out[f"conv{conv_idx}_b"] = torch.zeros((cout,), dtype=torch.float32)
            if i == n_convs - 1:          # stage tap
                out[f"lin{conv_idx}"] = torch.from_numpy(
                    np.abs(rng.randn(cout)).astype(np.float32) / cout)
            cin = cout
            conv_idx += 1
    return out


def default_weights() -> Optional[dict]:
    """Weights from ``CROPNERF_LPIPS_WEIGHTS`` (cached), or None."""
    global _DEFAULT_WEIGHTS, _DEFAULT_LOADED
    if not _DEFAULT_LOADED:
        _DEFAULT_LOADED = True
        p = os.environ.get("CROPNERF_LPIPS_WEIGHTS")
        if p and p.strip().lower() == "uncalibrated":
            print("lpips: using UNCALIBRATED deterministic random VGG "
                  "weights (CROPNERF_LPIPS_WEIGHTS=uncalibrated) — values "
                  "are only comparable within this configuration, not to "
                  "published LPIPS numbers", flush=True)
            _DEFAULT_WEIGHTS = uncalibrated_weights()
        elif p:
            _DEFAULT_WEIGHTS = load_weights(Path(p))
    return _DEFAULT_WEIGHTS


def reset_weights_cache() -> None:
    """Drop the cached default weights (tests toggle the env var)."""
    global _DEFAULT_WEIGHTS, _DEFAULT_LOADED
    _DEFAULT_WEIGHTS, _DEFAULT_LOADED = None, False


def lpips_available() -> bool:
    return default_weights() is not None


def _normalize(feat: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((feat ** 2).sum(dim=1, keepdim=True))
    return feat / n.clamp_min(1e-10)


_UNSET = object()


def lpips(pred: torch.Tensor, target: torch.Tensor,
          weights=_UNSET) -> Optional[torch.Tensor]:
    """pred/target [H, W, 3] in [0, 1].  Returns the LPIPS distance (a 0-dim
    tensor on pred's device), or ``None`` when no weights are available.
    ``weights`` defaults to :func:`default_weights`."""
    if weights is _UNSET:
        weights = default_weights()
    if weights is None:
        return None
    dev = pred.device
    shift = torch.tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev).view(1, 3, 1, 1)

    def prep(img):
        x = img.float().permute(2, 0, 1)[None]                  # [1,3,H,W]
        return ((x * 2.0 - 1.0) - shift) / scale

    x, y = prep(pred), prep(target)
    dist = torch.zeros((1,), device=dev)
    conv_idx = 0
    while f"conv{conv_idx}_w" in weights:
        # the file's HWIO kernels as conv2d's OIHW
        w = weights[f"conv{conv_idx}_w"].to(dev).permute(3, 2, 0, 1)
        b = weights[f"conv{conv_idx}_b"].to(dev)
        x = F.relu(F.conv2d(x, w, b, padding="same"))
        y = F.relu(F.conv2d(y, w, b, padding="same"))
        if f"lin{conv_idx}" in weights:
            # tap: unit-normalise channels, squared diff, per-channel lin
            # calibration summed over channels, spatial mean
            d = (_normalize(x) - _normalize(y)) ** 2
            lin = weights[f"lin{conv_idx}"].to(dev).view(1, -1, 1, 1)
            dist = dist + (d * lin).sum(dim=1).mean(dim=(1, 2))
            # maxpool between VGG stages (JAX pools after the last tap too,
            # which changes nothing)
            if f"conv{conv_idx + 1}_w" in weights:
                x = F.max_pool2d(x, 2)
                y = F.max_pool2d(y, 2)
        conv_idx += 1
    return dist[0]
