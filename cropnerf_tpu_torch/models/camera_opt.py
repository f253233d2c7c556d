"""Camera-pose optimisation: per-camera SO3xR3 tangent deltas (counterpart
of ``cropnerf_tpu/models/camera_opt.py``)."""
from __future__ import annotations

import torch

from ..core.rays import RayBundle


def camera_opt_init(num_cameras: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Zero [N, 6] tangent deltas: (tx, ty, tz, rx, ry, rz)."""
    return torch.zeros((num_cameras, 6), dtype=torch.float32, device=device)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: so(3) vectors [..., 3] → rotations [..., 3, 3].
    The norm is taken with a 1e-24 floor and the result Taylor-guarded
    below 1e-8, so the gradient stays finite at the zero init."""
    theta = torch.sqrt((omega ** 2).sum(dim=-1, keepdim=True) + 1e-24)
    axis = omega / theta
    theta = theta[..., None]
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zeros, -kz, ky], dim=-1),
        torch.stack([kz, zeros, -kx], dim=-1),
        torch.stack([-ky, kx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-8, eye + K * theta, R)


def apply_to_raybundle(pose_adjustment: torch.Tensor, ray_bundle: RayBundle,
                       mode: str = "SO3xR3") -> RayBundle:
    """origins += t, directions ← R(omega) · directions, per ray's camera
    (nerfstudio ``CameraOptimizer.apply_to_raybundle``)."""
    if mode == "off":
        return ray_bundle
    adj = pose_adjustment[ray_bundle.camera_idx]                   # [R, 6]
    origins = ray_bundle.origins + adj[:, :3]
    R = exp_so3(adj[:, 3:])                                        # [R, 3, 3]
    directions = torch.einsum("rij,rj->ri", R, ray_bundle.directions)
    return ray_bundle.replace(origins=origins, directions=directions)
