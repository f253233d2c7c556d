"""Depth-based (NeRF-free) semantic projection + its merger variant.

The port's own copy of ``cropnerf_tpu/counting/depth_projection.py``:
its code is held equal by tests/test_torch_copies.py, so that both
packages read and write the same artifacts.

Equivalents of the reference's CPU z-buffer alternative to the NeRF
projection pass:
  * the reference's crop_nerf/fruit_nerf/scripts/
    depth_based_semantic_projection.py:31-167 — pinhole projection matrix,
    z-buffer over the full-tree cloud, per-subcluster visibility rasters →
    ``occ_free_{i}.png`` / ``visible_label.png`` / ``visible.png``;
  * the reference's crop_nerf/segmentation/
    depth_projection_based_merger.py:259-394 — reliability =
    overlap/wo_occ, row-normalised affinity, default 'community' partition.

The rasteriser is vectorised numpy (np.minimum.at z-buffers) instead of the
reference's per-point Python loop.
"""
from __future__ import annotations

import dataclasses
import shutil
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from .graph import partition
from .merger import EPS, CountResult


def projection_matrix(fx: float, fy: float, cx: float, cy: float,
                      c2w: np.ndarray) -> np.ndarray:
    """3x4 projection P = K [R|t] for the OpenGL-convention c2w
    (depth_based_semantic_projection.py:31-45)."""
    rot_inv = c2w[:3, :3].T
    t = -rot_inv @ c2w[:3, 3]
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = rot_inv
    extrinsic[:3, 3] = t
    K = np.array([[fx, 0, -cx, 0],
                  [0, -fy, -cy, 0],
                  [0, 0, 1, 0]], np.float64)
    return K @ extrinsic


def project_points(P: np.ndarray, points: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (ys, xs, depth) pixel coords (rounded ints) + positive depth."""
    h = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    im = (P @ h.T).T
    z = -im[:, 2]
    z = np.maximum(z, 1e-9)
    ys = np.round(im[:, 0] / z).astype(np.int64)
    xs = np.round(im[:, 1] / z).astype(np.int64)
    return ys, xs, z


def zbuffer(points: np.ndarray, P: np.ndarray, height: int, width: int
            ) -> np.ndarray:
    """Per-pixel min depth of the cloud (inf where empty)."""
    ys, xs, z = project_points(P, points)
    ys = np.clip(ys, 0, width - 1)
    xs = np.clip(xs, 0, height - 1)
    buf = np.full((height, width), np.inf, np.float32)
    np.minimum.at(buf, (xs, ys), z.astype(np.float32))
    return buf


@dataclasses.dataclass
class DepthProjectionConfig:
    height: int = 1440
    width: int = 1920
    depth_tolerance: float = 1.0   # relative tolerance on z-buffer test


def project_super_clusters_for_camera(
        camera: Dict, cluster_info: np.ndarray, full_tree_pc: np.ndarray,
        save_dir: Path, cfg: DepthProjectionConfig = DepthProjectionConfig(),
        instance_mask_path: Optional[Path] = None) -> None:
    """Write the depth-projection artifact tree for one camera
    (project_and_save_super_clusters, :120-167).

    camera: {"fx","fy","cx","cy","c2w","index"}.
    """
    H, W = cfg.height, cfg.width
    P = projection_matrix(camera["fx"], camera["fy"], camera["cx"],
                          camera["cy"], np.asarray(camera["c2w"]))
    full_buf = zbuffer(full_tree_pc, P, H, W)
    cam_idx = camera["index"]

    for sup_idx, info in enumerate(cluster_info):
        cam_dir = Path(save_dir) / f"super_cluster_{sup_idx}" / f"cam_{cam_idx}"
        cam_dir.mkdir(parents=True, exist_ok=True)
        visible_label = np.zeros((H, W), np.uint8)
        for sub_idx, pc in info["pcd"].items():
            ys, xs, z = project_points(P, pc)
            inb = (ys >= 0) & (ys < W) & (xs >= 0) & (xs < H)
            ys, xs, z = ys[inb], xs[inb], z[inb]
            # occlusion-free: every pixel the subcluster projects to
            occ_free = np.zeros((H, W), np.uint8)
            occ_free[xs, ys] = 255
            cv2.imwrite(str(cam_dir / f"occ_free_{sub_idx}.png"), occ_free)
            # visible: pixels where the subcluster is at the front of the
            # full-tree z-buffer
            vis = z <= cfg.depth_tolerance * full_buf[xs, ys] + 1e-6
            visible_label[xs[vis], ys[vis]] = sub_idx + 1
            if instance_mask_path is not None and Path(instance_mask_path).exists():
                shutil.copy(instance_mask_path, cam_dir)
        cv2.imwrite(str(cam_dir / "visible_label.png"), visible_label)
        cv2.imwrite(str(cam_dir / "visible.png"),
                    np.where(visible_label > 0, 255, 0).astype(np.uint8))


# ---------------------------------------------------------------------------
# Depth-projection merger (depth_projection_based_merger.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DepthMergerConfig:
    graph_partition: str = "community"        # :310 default
    binary_threshold: int = 100
    frame_sampling_interval: int = 10
    max_super_clusters: int = 17
    # Count only this supercluster (-1 = all); ≙ :312 — note the reference
    # defaults this to 0 (single cluster), we default to counting all.
    super_cluster_idx: int = -1


def _areas_for_subcluster(cam_dir: Path, cid: int, thres: int
                          ) -> Tuple[float, int, float, float]:
    """(wo_occ_area, label, overlap_area, visible_area) from the depth
    artifacts (depth_projection_based_merger.py:200-260 semantics)."""
    occ_path = cam_dir / f"occ_free_{cid}.png"
    vis_path = cam_dir / "visible_label.png"
    label_paths = sorted(cam_dir.glob("label_*.png")) or \
        sorted(cam_dir.glob("*Segmentation*.png"))
    occ = cv2.imread(str(occ_path), cv2.IMREAD_GRAYSCALE)
    vis = cv2.imread(str(vis_path), cv2.IMREAD_GRAYSCALE)
    if occ is None or vis is None:
        return EPS, 0, EPS, EPS
    wo_occ_mask = occ > thres
    wo_occ = float(wo_occ_mask.sum())
    if wo_occ < 10:
        return EPS, 0, EPS, EPS
    vis_mask = vis == (cid + 1)
    vis_area = float(vis_mask.sum())
    if not label_paths or vis_area < 1:
        return wo_occ, 0, EPS, vis_area
    gt = cv2.imread(str(label_paths[0]), cv2.IMREAD_GRAYSCALE)
    labels = gt[vis_mask]
    counted = sorted(((v, k) for k, v in Counter(labels.tolist()).items()),
                     reverse=True)
    area, label = counted[0]
    area = 0.0 if label == 0 else float(area)
    return wo_occ, int(label), area, vis_area


def count_instances_depth(projection_dir: Path, cluster_info: np.ndarray,
                          cfg: DepthMergerConfig = DepthMergerConfig()
                          ) -> CountResult:
    """Counting over depth-projection artifacts: reliability =
    overlap/wo_occ (:259-263), affinity rows normalised before partition
    (:341)."""
    projection_dir = Path(projection_dir)
    n_super = min(cfg.max_super_clusters, len(cluster_info))
    if cfg.super_cluster_idx >= 0:
        if cfg.super_cluster_idx >= n_super:
            raise ValueError(f"super_cluster_idx={cfg.super_cluster_idx} "
                             f"out of range (have {n_super} superclusters)")
        indices = [cfg.super_cluster_idx]
    else:
        indices = list(range(n_super))
    total = 0
    counts, labels_list, affinities = [], [], []
    for s in indices:
        sc_dir = projection_dir / f"super_cluster_{s}"
        cam_dirs = sorted(sc_dir.glob("cam_*"))
        n_cams = max((int(d.name.split("_")[-1]) for d in cam_dirs),
                     default=-1) + 1
        n_sub = cluster_info[s]["aabb"].shape[0]
        rel = np.full((n_sub, n_cams), EPS)
        lab = np.zeros((n_sub, n_cams))
        for cam_dir in cam_dirs[::cfg.frame_sampling_interval]:
            c = int(cam_dir.name.split("_")[-1])
            for i in range(n_sub):
                wo_occ, label, overlap, _ = _areas_for_subcluster(
                    cam_dir, i, cfg.binary_threshold)
                rel[i, c] = overlap / wo_occ
                lab[i, c] = label
        affinity = np.zeros((n_sub, n_sub))
        for i in range(n_sub):
            for j in range(i + 1, n_sub):
                same = (lab[i] == lab[j]) & (lab[i] != 0) & (lab[j] != 0)
                diff = (lab[i] != lab[j]) & (lab[i] != 0) & (lab[j] != 0)
                affinity[i, j] = affinity[j, i] = (
                    rel[i][same] @ rel[j][same] - rel[i][diff] @ rel[j][diff])
        row_max = np.abs(affinity).max(axis=1, keepdims=True)
        norm = np.divide(affinity, row_max, out=np.zeros_like(affinity),
                         where=row_max > 0)
        n_comp, labels = partition(norm, cfg.graph_partition)
        counts.append(n_comp)
        labels_list.append(labels + total)
        affinities.append(affinity)
        total += n_comp
    print(f"Total bool: {total}")
    return CountResult(total_count=total, per_super_cluster=counts,
                       labels=labels_list, affinities=affinities)
