"""Host-side point-cloud primitives (counterpart of
``cropnerf_tpu/counting/clustering.py``), numpy and scipy only.

The port's own copy of the functions its exports need so far: the
statistical outlier removal of the depth point cloud (Open3D
``remove_statistical_outlier`` semantics, the scipy path of the JAX
module).  The JAX module's native C++ backend (``cropnerf_tpu/native``) is
not ported; the rest of the module follows with the counting slice.
"""
from __future__ import annotations

import numpy as np


def statistical_outlier_removal(points: np.ndarray, nb_neighbors: int = 20,
                                std_ratio: float = 2.0) -> np.ndarray:
    """Index array of inliers: drop points whose mean distance to their
    ``nb_neighbors`` nearest neighbours exceeds the global mean + std_ratio
    · std of that distance."""
    if len(points) <= nb_neighbors:
        return np.arange(len(points))
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    dists, _ = tree.query(points, k=nb_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.where(mean_d <= thresh)[0]
