"""Host-side point-cloud primitives: voxel downsample, DBSCAN, outlier
removal, KMeans, AABBs.

The port's own copy of ``cropnerf_tpu/counting/clustering.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Equivalents of the Open3D/sklearn calls in the reference segmentation stage
(the reference's crop_nerf/segmentation/segmenter.py:69-112,
clustering.py:18-96).  Open3D is unavailable here; these are numpy/sklearn
implementations behind a stable interface — the native C++ backend
(cropnerf_tpu_torch/native, built into cropnerf_tpu_torch/_build at
first use) plugs in behind the same functions when built.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _native():
    try:
        from ..native import pointcloud_ops as nat
        return nat if nat.available() else None
    except Exception:
        return None


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     colors: Optional[np.ndarray] = None):
    """Average points (and colors) per occupied voxel (Open3D
    ``voxel_down_sample`` semantics, segmenter.py:70)."""
    nat = _native()
    if nat is not None and colors is None:
        return nat.voxel_downsample(points, voxel_size)
    keys = np.floor(points / voxel_size).astype(np.int64)
    # unique over rows
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    n_vox = counts.shape[0]
    sums = np.zeros((n_vox, 3), np.float64)
    np.add.at(sums, inv, points)
    out_pts = (sums / counts[:, None]).astype(np.float32)
    if colors is not None:
        csum = np.zeros((n_vox, colors.shape[1]), np.float64)
        np.add.at(csum, inv, colors)
        return out_pts, (csum / counts[:, None]).astype(colors.dtype)
    return out_pts


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Density-based clustering → labels [N] (noise = -1); Open3D
    ``cluster_dbscan`` semantics (segmenter.py:74)."""
    nat = _native()
    if nat is not None:
        return nat.dbscan(points, eps, min_points)
    from sklearn.cluster import DBSCAN
    return DBSCAN(eps=eps, min_samples=min_points).fit_predict(points)


def statistical_outlier_removal(points: np.ndarray, nb_neighbors: int = 20,
                                std_ratio: float = 2.0) -> np.ndarray:
    """Index mask of inliers (Open3D ``remove_statistical_outlier``
    semantics, segmenter.py:80-86): drop points whose mean k-NN distance
    exceeds global mean + std_ratio * std."""
    if len(points) <= nb_neighbors:
        return np.arange(len(points))
    nat = _native()
    if nat is not None:
        return nat.statistical_outlier_removal(points, nb_neighbors,
                                               std_ratio)
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dists, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.where(mean_d <= thresh)[0]


def kmeans(points: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """KMeans labels [N] (sklearn semantics, segmenter.py:164,183-185)."""
    nat = _native()
    if nat is not None:
        return nat.kmeans(points, k, seed)
    from sklearn.cluster import KMeans
    return KMeans(n_clusters=k, n_init=10, random_state=seed
                  ).fit_predict(points)


def kmeans_elbow(points: np.ndarray, k_max: int = 10,
                 inertia_delta: float = 10.0, seed: int = 0) -> np.ndarray:
    """KMeans with elbow stopping: grow k until the inertia improvement
    drops below ``inertia_delta`` (clustering.py:71-86)."""
    from sklearn.cluster import KMeans
    prev_inertia = None
    labels = np.zeros(len(points), np.int64)
    for k in range(1, k_max + 1):
        km = KMeans(n_clusters=k, n_init=10, random_state=seed).fit(points)
        if prev_inertia is not None and prev_inertia - km.inertia_ < inertia_delta:
            break
        labels = km.labels_
        prev_inertia = km.inertia_
    return labels


def spectral_clustering(points: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Spectral clustering labels (clustering.py:88-96)."""
    from sklearn.cluster import SpectralClustering
    return SpectralClustering(n_clusters=k, random_state=seed,
                              affinity="nearest_neighbors",
                              n_neighbors=min(10, len(points) - 1)
                              ).fit_predict(points)


def aabb(points: np.ndarray) -> np.ndarray:
    """[2, 3] axis-aligned bounding box."""
    return np.stack([points.min(axis=0), points.max(axis=0)])
