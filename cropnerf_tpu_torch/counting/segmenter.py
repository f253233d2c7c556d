"""Supercluster / subcluster segmentation of the exported semantic cloud.

The port's own copy of ``cropnerf_tpu/counting/segmenter.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Equivalent of the reference's crop_nerf/segmentation/segmenter.py:
  * :func:`get_super_clusters` ≙ segmenter.py:69-86 — voxel downsample,
    DBSCAN(eps = 20·voxel, min_points=30), drop noise, statistical outlier
    removal (20, 2.0);
  * :func:`process_and_save_all` ≙ segmenter.py:153-185 — size-sorted
    superclusters → KMeans(k) subclusters → per-subcluster AABBs, saved to
    ``all_super_cluster_info_nsub_{k}.npy`` as a list of
    ``{'aabb': [k,2,3], 'pcd': {i: points}}`` dicts (the exact artifact
    format the projection + merger stages consume).
"""
from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..export.ply import read_ply
from . import clustering


def get_super_clusters(points: np.ndarray, vx_size: float = 10e-5
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(points, labels) after downsample + DBSCAN + outlier removal.
    ``vx_size``: 1e-4 for apple/cotton, 1e-5 for pear (segmenter.py:69)."""
    down = clustering.voxel_downsample(points, vx_size)
    labels = clustering.dbscan(down, eps=20 * vx_size, min_points=30)
    keep = labels >= 0
    down, labels = down[keep], labels[keep]
    ind = clustering.statistical_outlier_removal(down, 20, 2.0)
    return down[ind], labels[ind]


def _size_sorted_labels(labels: np.ndarray) -> List[int]:
    return [lbl for _, lbl in sorted(
        ((cnt, lbl) for lbl, cnt in Counter(labels.tolist()).items()),
        reverse=True)]


def bounds_as_sorted_list(points: np.ndarray, labels: np.ndarray
                          ) -> List[np.ndarray]:
    """Per-cluster AABBs, largest cluster first (segmenter.py:102-112)."""
    return [clustering.aabb(points[labels == lbl])
            for lbl in _size_sorted_labels(labels)]


def build_super_cluster_info(points: np.ndarray, k: int = 2,
                             vx_size: float = 10e-5) -> List[dict]:
    """Size-sorted superclusters → KMeans(k) subclusters with AABBs
    (segmenter.py:153-181)."""
    pts, labels = get_super_clusters(points, vx_size)
    res = []
    for lbl in _size_sorted_labels(labels):
        cluster = pts[labels == lbl]
        if len(cluster) <= k:
            continue
        sub = clustering.kmeans(cluster, k)
        aabbs, pc_list = [], []
        for i in range(k):
            part = cluster[sub == i]
            if len(part) == 0:           # degenerate KMeans cell
                part = cluster[:1]
            aabbs.append(clustering.aabb(part))
            pc_list.append(part)
        res.append({"aabb": np.stack(aabbs),
                    "pcd": {i: pc for i, pc in enumerate(pc_list)}})
    return res


def process_for_pipeline(input_path: Path, dataname: str = "semantic.ply",
                         k: int = 2, vx_size: float = 10e-5) -> Path:
    """Read the exported cloud, cluster, save
    ``all_super_cluster_info_nsub_{k}.npy`` (segmenter.py:183-185)."""
    input_path = Path(input_path)
    points, _ = read_ply(input_path / dataname)
    info = build_super_cluster_info(points, k=k, vx_size=vx_size)
    save_path = input_path / f"all_super_cluster_info_nsub_{k}.npy"
    np.save(save_path, np.array(info, dtype=object), allow_pickle=True)
    print(f"Point cloud info saved to {save_path} "
          f"({len(info)} superclusters)")
    return save_path
