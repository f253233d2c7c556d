"""Ray and sample containers (counterpart of ``cropnerf_tpu/core/rays.py``):
plain dataclasses of tensors."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class RayBundle:
    """A batch of rays; every leading dim is the ray batch ``[R]``.

    origins/directions [R, 3], nears/fars [R], camera_idx [R] int,
    mask [R] float {0,1} validity or None.
    """

    origins: torch.Tensor
    directions: torch.Tensor
    nears: torch.Tensor
    fars: torch.Tensor
    camera_idx: torch.Tensor
    mask: Optional[torch.Tensor] = None

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class RaySamples:
    """Per-ray samples: euclidean bin edges starts/ends [R, S] and the
    sampler's normalised s-space edges spacing_starts/spacing_ends."""

    origins: torch.Tensor         # [R, 3]
    directions: torch.Tensor      # [R, 3]
    starts: torch.Tensor          # [R, S]
    ends: torch.Tensor            # [R, S]
    spacing_starts: torch.Tensor  # [R, S]
    spacing_ends: torch.Tensor    # [R, S]
    camera_idx: torch.Tensor      # [R]

    @property
    def positions(self) -> torch.Tensor:
        """Sample midpoints in world space, [R, S, 3]."""
        mids = 0.5 * (self.starts + self.ends)
        return (self.origins[:, None, :]
                + mids[..., None] * self.directions[:, None, :])

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def midpoints(self) -> torch.Tensor:
        return 0.5 * (self.starts + self.ends)


def ray_samples_from_bins(ray_bundle: RayBundle, spacing_bins: torch.Tensor,
                          s_to_t: Callable) -> RaySamples:
    """RaySamples from monotone s-space bin edges [R, S+1]."""
    t_bins = s_to_t(spacing_bins)
    return RaySamples(
        origins=ray_bundle.origins,
        directions=ray_bundle.directions,
        starts=t_bins[..., :-1],
        ends=t_bins[..., 1:],
        spacing_starts=spacing_bins[..., :-1],
        spacing_ends=spacing_bins[..., 1:],
        camera_idx=ray_bundle.camera_idx,
    )
