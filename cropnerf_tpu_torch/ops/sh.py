"""Real spherical-harmonics direction encoding up to degree 4 (counterpart
of ``cropnerf_tpu/ops/sh.py``, tiny-cuda-nn's ``SHEncoding``): tcnn's
component order (l-major, m from -l to l) and hard-coded constants."""
from __future__ import annotations

import torch


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Unit directions [..., 3] → [..., levels²] SH basis values."""
    if not 1 <= levels <= 4:
        raise ValueError(f"SH levels must be in [1, 4], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    comps = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if levels >= 2:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels >= 3:
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525252005,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if levels >= 4:
        comps += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)
