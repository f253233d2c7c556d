"""Sinusoidal positional encoding (counterpart of
``cropnerf_tpu/ops/posenc.py``, nerfstudio ``NeRFEncoding``)."""
from __future__ import annotations

import torch


def nerf_encoding(x: torch.Tensor, num_frequencies: int,
                  min_freq_exp: float = 0.0,
                  max_freq_exp: float | None = None,
                  include_input: bool = True) -> torch.Tensor:
    """[..., D] → [..., D * (2F + include_input)]: [x | sin block | cos
    block], each block frequency-major, frequencies 2^k for k in
    linspace(min_freq_exp, max_freq_exp, F)."""
    if max_freq_exp is None:
        max_freq_exp = num_frequencies - 1
    freqs = 2.0 ** torch.linspace(min_freq_exp, max_freq_exp,
                                  num_frequencies, device=x.device)
    xb = x[..., None, :] * freqs[:, None]              # [..., F, D]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
