"""Depth-based point-cloud export from rendered training rays (counterpart
of ``cropnerf_tpu/export/pointcloud.py``, the reference's ``ns-export
pointcloud --num-points 10000000`` path).

Random ray batches of the training views are drawn from the pixel bank
with an explicit ``torch.Generator`` and rendered on the device by
``forward`` (both proposal nets and the field run on every batch); a point
sits at origin + direction · median depth, and a ray is kept where its
accumulation (and, with ``only_semantics``, its semantic colormap) passes
the threshold.  Only the kept points and colours cross to the host, once
per batch.  Statistical outliers are then removed on the host by a k-d
tree queried on every core (the JAX exporter calls the counting stage's
native backend, whose grid suits volume-filling clouds, not these
surfaces); normals, when asked for, are PCA over the k nearest neighbours.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.cameras import generate_rays, near_far_collider
from ..core.rays import RayBundle
from ..data.databank import PixelBank, decode_pixel_index
from ..models.config import ModelConfig
from ..models.model import CropNeRFParams, forward
from .ply import write_ply


@torch.no_grad()
def depth_points(params: CropNeRFParams, model_cfg: ModelConfig,
                 bank: PixelBank, idx: torch.Tensor,
                 only_semantics: bool = True,
                 semantic_threshold: float = 0.5,
                 accumulation_threshold: float = 0.5,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch of the export for the bank pixels ``idx`` [R]: (points
    [R, 3], colours [R, 3], keep [R] bool), on the bank's device."""
    cam, px, py = decode_pixel_index(idx, bank.height, bank.width)
    origins, dirs = generate_rays(bank.cameras, cam, px, py)
    n = idx.shape[0]
    rb = RayBundle(origins=origins, directions=dirs,
                   nears=torch.zeros((n,), device=origins.device),
                   fars=torch.ones((n,), device=origins.device),
                   camera_idx=cam)
    rb = near_far_collider(rb, model_cfg.near_plane, model_cfg.far_plane)
    out = forward(params, rb, model_cfg, train=False,
                  compute_dtype=compute_dtype)
    depth = out["depth"][..., 0]
    pts = origins + dirs * depth[..., None]
    keep = out["accumulation"][..., 0] > accumulation_threshold
    if only_semantics:
        keep = keep & (out["semantics_colormap"][..., 0] > semantic_threshold)
    return pts, out["rgb"], keep


def generate_point_cloud(params: CropNeRFParams, model_cfg: ModelConfig,
                         bank: PixelBank, num_points: int = 1_000_000,
                         rays_per_batch: int = 16384,
                         only_semantics: bool = True,
                         semantic_threshold: float = 0.5,
                         accumulation_threshold: float = 0.5,
                         remove_outliers: bool = True,
                         std_ratio: float = 10.0,
                         seed: int = 0,
                         max_batches: int = 2000,
                         generator: Optional[torch.Generator] = None,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(points [N, 3], colours [N, 3]) float32 in the dataparser frame.

    Each batch draws ``rays_per_batch`` pixel indices from ``generator``
    (default: one on the bank's device seeded with ``seed``) until
    ``num_points`` points are kept or ``max_batches`` batches ran."""
    device = bank.rgb.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    points, colors = [], []
    total = 0
    for _ in range(max_batches):
        idx = torch.randint(0, bank.num_pixels, (rays_per_batch,),
                            generator=generator,
                            device=generator.device).to(device)
        pts, rgb, keep = depth_points(params, model_cfg, bank, idx,
                                      only_semantics, semantic_threshold,
                                      accumulation_threshold, compute_dtype)
        kept = torch.cat([pts[keep], rgb[keep]], dim=1).cpu().numpy()
        points.append(kept[:, :3])
        colors.append(kept[:, 3:])
        total += len(kept)
        if total >= num_points:
            break
    if not points:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    pts = np.concatenate(points)[:num_points]
    cols = np.concatenate(colors)[:num_points]
    if remove_outliers and len(pts) > 50:
        keep = outlier_inliers(pts, 20, std_ratio)
        pts, cols = pts[keep], cols[keep]
    return pts.astype(np.float32), cols.astype(np.float32)


def outlier_inliers(points: np.ndarray, nb_neighbors: int = 20,
                    std_ratio: float = 2.0) -> np.ndarray:
    """Index array of inliers (Open3D ``remove_statistical_outlier``
    semantics, the scipy path of ``counting.clustering``'s
    ``statistical_outlier_removal``, whose indices it returns): drop points
    whose mean distance to their ``nb_neighbors`` nearest neighbours
    exceeds the global mean + std_ratio · std of that distance.

    The native backend sizes its search grid for a volume-filling cloud;
    on a surface cloud each occupied cell holds thousands of points, and
    its time grows as n^1.45, on one thread where the compiler has no
    OpenMP: a 1,000,000-point depth cloud took minutes (PERF.md §6).  The
    k-d tree query runs on every core."""
    if len(points) <= nb_neighbors:
        return np.arange(len(points))
    from scipy.spatial import cKDTree
    dists, _ = cKDTree(points).query(points, k=nb_neighbors + 1, workers=-1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.where(mean_d <= thresh)[0]


def estimate_normals(points: np.ndarray, k: int = 10,
                     orient_towards: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """PCA normals over the k nearest neighbours (Open3D estimate_normals
    and orient_normals semantics): one KD-tree query, a batched covariance
    and one stacked [N, 3, 3] eigendecomposition; the smallest-variance
    axis, flipped towards ``orient_towards`` when given."""
    from scipy.spatial import cKDTree
    pts = np.asarray(points, np.float64)
    tree = cKDTree(pts)
    _, nbrs = tree.query(pts, k=k + 1, workers=-1)
    nb = pts[nbrs[:, 1:]]                       # [N, k, 3]
    nb = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nb, nb) / max(k - 1, 1)   # [N, 3, 3]
    _, vecs = np.linalg.eigh(cov)               # ascending eigenvalues
    normals = vecs[..., 0].astype(np.float32)   # smallest-variance axis
    if orient_towards is not None:
        to_view = orient_towards[None, :] - points
        flip = np.sum(normals * to_view, axis=1) < 0
        normals[flip] *= -1
    n = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(n, 1e-12)


def export_depth_pointcloud(params: CropNeRFParams, model_cfg: ModelConfig,
                            bank: PixelBank, output_path: Path,
                            normals_k: Optional[int] = None,
                            scale_factor: float = 1.0,
                            **kwargs) -> Path:
    """Write the depth cloud to ``output_path`` (``semantics_pc.ply`` in the
    CLI).  ``normals_k``: estimate PCA normals over k-NN, oriented towards
    the centroid's +z viewpoint, and store them as nx/ny/nz.
    ``scale_factor`` multiplies the points on write.  ``kwargs`` go to
    :func:`generate_point_cloud`."""
    pts, cols = generate_point_cloud(params, model_cfg, bank, **kwargs)
    normals = None
    if normals_k:
        if len(pts) > normals_k + 1:
            centroid = (pts.mean(axis=0)
                        + np.array([0.0, 0.0, 1.0], np.float32))
            normals = estimate_normals(pts, k=normals_k,
                                       orient_towards=centroid)
        else:
            warnings.warn(
                f"normals requested (k={normals_k}) but the cloud has only "
                f"{len(pts)} points: writing the PLY without nx/ny/nz",
                stacklevel=2)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    write_ply(output_path, pts * scale_factor, cols, normals=normals)
    return output_path
