"""Ray samplers: spaced and inverse-CDF resampling (counterpart of
``cropnerf_tpu/ops/pdf.py``).

Jitter comes either from a ``torch.Generator`` or from a noise tensor the
caller passes, so a test can feed this module and the JAX package the same
draws.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.rays import RayBundle, RaySamples, ray_samples_from_bins

Spacing = Tuple[Callable, Callable]


def spacing_uniform() -> Spacing:
    return (lambda t: t), (lambda s: s)


def spacing_piecewise() -> Spacing:
    """Uniform in [near, 1], uniform in disparity beyond (nerfstudio
    ``UniformLinDispPiecewiseSampler``).  fn: t<1 → t/2, else 1 - 1/(2t)."""
    def fn(t):
        return torch.where(t < 1.0, t / 2.0,
                           1.0 - 1.0 / (2.0 * t.clamp_min(1e-12)))

    def inv(s):
        return torch.where(s < 0.5, 2.0 * s,
                           1.0 / (2.0 - 2.0 * s).clamp_min(1e-12))

    return fn, inv


def make_s_to_t(spacing: Spacing, nears: torch.Tensor,
                fars: torch.Tensor) -> Callable:
    """Bind a spacing-function pair to per-ray near/far: s in [0,1] → t."""
    fn, inv = spacing
    s_near = fn(nears)[..., None]
    s_far = fn(fars)[..., None]

    def s_to_t(s):
        return inv(s_near + s * (s_far - s_near))

    return s_to_t


def linspace(stop: float, num: int,
             device: torch.device | str = "cpu") -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32, bit for bit as XLA
    evaluates it: i · ((1/(num-1)) · stop), with the endpoint exact.
    ``torch.linspace`` rounds differently, and sample positions would
    differ from the JAX package's in the last bit."""
    f32 = torch.float32
    step = ((torch.tensor(1.0, dtype=f32) / (num - 1))
            * torch.tensor(stop, dtype=f32)).to(device)
    out = torch.arange(num - 1, dtype=f32, device=device) * step
    return torch.cat([out, torch.tensor([stop], dtype=f32, device=device)])


def _draw(shape, like: torch.Tensor, generator: Optional[torch.Generator],
          noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        return noise.to(device=like.device, dtype=like.dtype)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.to(device=like.device, dtype=like.dtype)


def sample_spaced(ray_bundle: RayBundle, num_samples: int, spacing: Spacing,
                  train: bool, single_jitter: bool = True, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> RaySamples:
    """Uniform-in-s stratified sampling: with jitter, each bin edge moves
    between its neighbouring bin centres.  Jitter applies when ``train`` and
    a generator or ``noise`` ([R, 1] or [R, S+1]) is given."""
    R = ray_bundle.num_rays
    device = ray_bundle.origins.device
    bins = linspace(1.0, num_samples + 1, device)
    bins = bins.expand(R, num_samples + 1)
    if train and (generator is not None or noise is not None):
        shape = (R, 1) if single_jitter else (R, num_samples + 1)
        t_rand = _draw(shape, bins, generator, noise)
        centers = 0.5 * (bins[..., 1:] + bins[..., :-1])
        upper = torch.cat([centers, bins[..., -1:]], dim=-1)
        lower = torch.cat([bins[..., :1], centers], dim=-1)
        bins = lower + (upper - lower) * t_rand
    s_to_t = make_s_to_t(spacing, ray_bundle.nears, ray_bundle.fars)
    return ray_samples_from_bins(ray_bundle, bins, s_to_t)


def sample_pdf(ray_bundle: RayBundle, existing_bins: torch.Tensor,
               weights: torch.Tensor, num_samples: int, spacing: Spacing,
               train: bool, single_jitter: bool = True,
               histogram_padding: float = 0.01,
               include_original: bool = False, *,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> RaySamples:
    """Inverse-CDF resampling of ``num_samples`` bins from a weight
    histogram over ``existing_bins`` (s-space [R, S+1]); weights [R, S].

    The JAX package finds the bracketing bins with masked min/max
    reductions over an [R, nb, S+1] broadcast.  The cdf and the bins are
    sorted, so ``searchsorted(right=True)`` names the same bins (the last
    cdf <= u below, the first cdf > u above, clipped to the last bin)
    without that temporary.
    """
    weights = weights.detach() + histogram_padding
    num_bins = num_samples + 1
    pdf = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-10)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    cdf = cdf.clamp_max(1.0)                                 # [R, S+1]

    R = weights.shape[0]
    base = linspace(1.0 - 1.0 / num_bins, num_bins,
                    weights.device).expand(R, num_bins)
    if train and (generator is not None or noise is not None):
        shape = (R, 1) if single_jitter else (R, num_bins)
        jitter = _draw(shape, base, generator, noise) / num_bins
    else:
        jitter = 0.5 / num_bins
    u = (base + jitter).contiguous()                         # [R, nb]

    last = cdf.shape[-1] - 1
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = above - 1              # >= 0: cdf[0] = 0 <= u
    above = above.clamp_max(last)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(existing_bins, -1, below)
    bins_g1 = torch.gather(existing_bins, -1, above)

    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 1e-10, (u - cdf_g0) / denom.clamp_min(1e-10),
                    torch.zeros_like(denom))
    t = t.clamp(0.0, 1.0)
    new_bins = bins_g0 + t * (bins_g1 - bins_g0)

    if include_original:
        new_bins = torch.sort(torch.cat([existing_bins, new_bins], dim=-1),
                              dim=-1).values

    s_to_t = make_s_to_t(spacing, ray_bundle.nears, ray_bundle.fars)
    return ray_samples_from_bins(ray_bundle, new_bins, s_to_t)


def sample_uniform_with_noise(ray_bundle: RayBundle, num_samples: int, *,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[torch.Tensor] = None
                              ) -> RaySamples:
    """Export-time sampler: uniform bins between near and far, each edge
    jittered independently when a generator or noise [R, S+1] is given."""
    return sample_spaced(ray_bundle, num_samples, spacing_uniform(),
                         train=generator is not None or noise is not None,
                         single_jitter=False, generator=generator,
                         noise=noise)
