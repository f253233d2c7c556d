"""Pinhole cameras, ray generation and AABB clipping (counterpart of
``cropnerf_tpu/core/cameras.py``).

OpenGL convention as transforms.json: camera -Z forward, +Y up; ``c2w`` is
[N, 3, 4] camera-to-world.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .rays import RayBundle


@dataclasses.dataclass
class Cameras:
    """N stacked cameras: c2w [N, 3, 4]; fx, fy, cx, cy [N] in pixels;
    width, height [N] int; distortion [N, 6] (k1, k2, k3, k4, p1, p2) or
    None."""

    c2w: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    distortion: Optional[torch.Tensor] = None

    @property
    def num_cameras(self) -> int:
        return self.c2w.shape[0]


def _undistort(x: torch.Tensor, y: torch.Tensor, coeffs: torch.Tensor,
               iters: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative inverse of the OpenCV radial/tangential distortion model."""
    k1, k2, k3, k4 = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2], coeffs[..., 3]
    p1, p2 = coeffs[..., 4], coeffs[..., 5]
    xu, yu = x, y
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xu = (x - dx) / radial
        yu = (y - dy) / radial
    return xu, yu


def generate_rays(cameras: Cameras, cam_idx: torch.Tensor,
                  pixel_x: torch.Tensor, pixel_y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays through pixel centres for (camera, x, y) index triples [R] →
    (origins [R, 3], unit directions [R, 3])."""
    fx = cameras.fx[cam_idx]
    fy = cameras.fy[cam_idx]
    cx = cameras.cx[cam_idx]
    cy = cameras.cy[cam_idx]
    c2w = cameras.c2w[cam_idx]                       # [R, 3, 4]

    x = (pixel_x.float() + 0.5 - cx) / fx
    y = (pixel_y.float() + 0.5 - cy) / fy
    if cameras.distortion is not None:
        x, y = _undistort(x, y, cameras.distortion[cam_idx])
    dirs_cam = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    dirs = torch.einsum("rij,rj->ri", c2w[:, :, :3], dirs_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = c2w[:, :, 3]
    return origins, dirs


def camera_ray_grid(cameras: Cameras, cam_index: int, height: int,
                    width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid for one camera → (origins [H*W, 3], dirs)."""
    device = cameras.c2w.device
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    idx = torch.full((height * width,), cam_index, dtype=torch.long,
                     device=device)
    return generate_rays(cameras, idx, xs.reshape(-1), ys.reshape(-1))


def ray_aabb_intersect(origins: torch.Tensor, directions: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection; aabb [2, 3].  Returns
    (nears [R], fars [R], hit mask [R] float {0,1})."""
    tiny = torch.where(directions >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(directions.abs() < 1e-12, tiny, directions)
    t0 = (aabb[0] - origins) * inv
    t1 = (aabb[1] - origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = tmin.clamp_min(min_near)
    fars = tmax
    hit = (fars > nears) & (fars > 0)
    nears = torch.where(hit, nears.clamp_min(0.0), 0.0)
    fars = torch.where(hit, fars, 1.0)
    return nears, fars, hit.float()


def near_far_collider(ray_bundle: RayBundle, near: float,
                      far: float) -> RayBundle:
    """Constant near/far assignment (nerfstudio ``NearFarCollider``)."""
    R = ray_bundle.num_rays
    device = ray_bundle.origins.device
    return ray_bundle.replace(
        nears=torch.full((R,), near, dtype=torch.float32, device=device),
        fars=torch.full((R,), far, dtype=torch.float32, device=device))
