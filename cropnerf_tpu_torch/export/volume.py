"""Orthographic semantic volume export → thresholded point clouds
(counterpart of ``cropnerf_tpu/export/volume.py``).

A grid of parallel rays enters one AABB face and crosses the box; each
fixed-size ray chunk goes through :func:`forward_export` on the device,
which keeps the samples whose density passes the threshold; only those rows
cross to the host.  Per-sample thresholds then split them into
semantic.ply (semantic logit >= 3 and density >= 70), semantic_colormap.ply
(sigmoid >= 0.9 and density) and density.ply (density alone).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.rays import RayBundle
from ..models.config import ModelConfig
from ..models.model import CropNeRFParams, forward_export
from .ply import write_ply

SEMANTIC_LOGIT_THRESHOLD = 3.0
DENSITY_THRESHOLD = 70.0
COLORMAP_THRESHOLD = 0.9


def orthographic_ray_grid(aabb: np.ndarray, n_per_side: int, axis: int = 2
                          ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Parallel-ray grid entering the ``axis``-min face of the AABB:
    (origins [M, 3], direction [3], far).  Ray counts on the two free axes
    are aspect-scaled: count_i = extent_i / extent_axis * n."""
    aabb = np.asarray(aabb, np.float32)
    extent = aabb[1] - aabb[0]
    free = [i for i in range(3) if i != axis]
    counts = [max(2, int(extent[i] / extent[axis] * n_per_side)) for i in free]
    lin = [np.linspace(aabb[0][i], aabb[1][i], c, dtype=np.float32)
           for i, c in zip(free, counts)]
    g0, g1 = np.meshgrid(lin[0], lin[1], indexing="ij")
    origins = np.zeros((g0.size, 3), np.float32)
    origins[:, free[0]] = g0.ravel()
    origins[:, free[1]] = g1.ravel()
    origins[:, axis] = aabb[0][axis]
    direction = np.zeros((3,), np.float32)
    direction[axis] = 1.0
    return origins, direction, float(extent[axis])


@dataclasses.dataclass
class ExportedCloud:
    points: np.ndarray
    colors: np.ndarray
    alpha: np.ndarray


@torch.no_grad()
def sample_volume(params: CropNeRFParams, model_cfg: ModelConfig,
                  aabb: np.ndarray, num_points_per_side: int = 3000,
                  rays_per_batch: int = 512,
                  num_samples: Optional[int] = None,
                  render_rgb: bool = False, axis: int = 2, seed: int = 0,
                  semantic_threshold: float = SEMANTIC_LOGIT_THRESHOLD,
                  density_threshold: float = DENSITY_THRESHOLD,
                  colormap_threshold: float = COLORMAP_THRESHOLD,
                  chunk_noise: Optional[Callable[[int], torch.Tensor]] = None,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, ExportedCloud]:
    """Dense volume sampling → {"semantic", "semantic_colormap", "density"}
    clouds in the dataparser frame.

    The sampler's jitter for chunk ``c`` is ``chunk_noise(c)`` ([B, S+1]
    uniform draws) when given, else drawn from a ``torch.Generator`` seeded
    with ``seed``.  The last chunk repeats its final origin up to the chunk
    size; those padding rays emit no points.
    """
    device = params.camera_opt.device
    num_samples = num_samples or num_points_per_side
    origins_np, dir_np, far = orthographic_ray_grid(aabb, num_points_per_side,
                                                    axis)
    B = rays_per_batch
    n_rays = origins_np.shape[0]
    n_chunks = (n_rays + B - 1) // B
    if n_rays < n_chunks * B:
        origins_np = np.concatenate(
            [origins_np,
             np.repeat(origins_np[-1:], n_chunks * B - n_rays, axis=0)], 0)
    origins = torch.from_numpy(origins_np).to(device)
    direction = torch.from_numpy(dir_np).to(device).expand(B, 3)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    generator = None
    if chunk_noise is None:
        generator = torch.Generator(device).manual_seed(seed)
    ray_of_row = torch.arange(B * num_samples, device=device) // num_samples

    rows = []
    for c in range(n_chunks):
        rb = RayBundle(
            origins=origins[c * B:(c + 1) * B], directions=direction,
            nears=torch.zeros((B,), device=device),
            fars=torch.full((B,), far, device=device),
            camera_idx=torch.zeros((B,), dtype=torch.long, device=device))
        noise = (chunk_noise(c) if chunk_noise is not None else
                 torch.rand((B, num_samples + 1), generator=generator,
                            device=device))
        out = forward_export(params, rb, model_cfg, num_samples, aabb_t,
                             render_rgb_samples=render_rgb, noise=noise,
                             compute_dtype=compute_dtype)
        density = out["density"].reshape(-1)
        keep = (density >= density_threshold) & (ray_of_row < n_rays - c * B)
        idx = keep.nonzero().squeeze(1)
        sem = out["semantics"].reshape(-1)[idx]
        sig = torch.sigmoid(sem)
        cols = [out["point_location"].reshape(-1, 3)[idx], sig[:, None],
                (sem >= semantic_threshold).float()[:, None],
                (sig >= colormap_threshold).float()[:, None]]
        if render_rgb:
            cols.append(out["rgb"].reshape(-1, 3)[idx])
        rows.append(torch.cat(cols, dim=1))
    rows = torch.cat(rows).cpu().numpy()

    pts, sig = rows[:, :3], rows[:, 3]
    result = {}
    for name, flag in (("semantic", rows[:, 4] > 0.5),
                       ("semantic_colormap", rows[:, 5] > 0.5),
                       ("density", np.ones((rows.shape[0],), bool))):
        colors = (rows[flag, 6:9] if render_rgb
                  else np.repeat(sig[flag][:, None], 3, axis=1))
        result[name] = ExportedCloud(points=pts[flag], colors=colors,
                                     alpha=sig[flag])
    return result


def unscale_points(points: np.ndarray, dataparser_scale: float,
                   factor: float = 2.0) -> np.ndarray:
    """Undo the dataparser pose scaling for exported clouds (the
    reference's 1/scale then ×2 artifact convention)."""
    return points * (factor / dataparser_scale)


def export_and_write(params: CropNeRFParams, model_cfg: ModelConfig,
                     aabb: np.ndarray, output_dir: Path,
                     dataparser_scale: float = 1.0,
                     **kwargs) -> Dict[str, Path]:
    """Sample the volume and write semantic.ply / semantic_colormap.ply /
    density.ply."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    clouds = sample_volume(params, model_cfg, aabb, **kwargs)
    paths = {}
    for name, cloud in clouds.items():
        p = output_dir / f"{name}.ply"
        write_ply(p, unscale_points(cloud.points, dataparser_scale),
                  cloud.colors, cloud.alpha)
        paths[name] = p
    return paths
