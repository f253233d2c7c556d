"""Crop-instance merging and counting — the paper's core algorithm.

The port's own copy of ``cropnerf_tpu/counting/merger.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Equivalent of the reference's crop_nerf/segmentation/merger.py:190-460:

  1. Per subcluster × sampled camera, score the projections
     (:func:`wo_occlusion_area`, :func:`visible_projection_stats`):
     occlusion-free area via binary threshold + largest contour; visible
     area, dominant GT instance label, and label-overlap area inside the
     occlusion-free bbox.
  2. Reliability per camera (``--area_normalize`` semantics, :313-320).
  3. Pairwise affinity: Σ rel_i·rel_j over cameras where both subclusters
     see the *same* nonzero GT label minus Σ where they see *different*
     labels (:335-355).
  4. Graph partition (clique / bridge / community) → instances; global
     label offsetting across superclusters → total crop count (:359-460).

Pure host-side (cv2 + numpy + networkx) exactly like the reference — the
inputs are PNG projections and the supercluster npy artifact.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from ..export.ply import write_ply
from .graph import partition

EPS = 1e-6


@dataclasses.dataclass
class MergerConfig:
    """Defaults ≙ merger.py:360-378."""
    visible_img_prefix: str = "visible_cluster"
    wo_occ_img_prefix: str = "wo_occ_cluster"
    area_normalize: bool = False
    graph_partition: str = "clique"
    binary_threshold: int = 100
    frame_sampling_interval: int = 10
    n_thread: int = 10
    max_super_clusters: int = 17
    # Label/projection resolution reconciliation + overlay debug artifacts
    # (≙ copy_with_scaling + overly_mask_with_projection, merger.py:145-189).
    # ``scale_factor`` maps the GT label resolution to the projection
    # resolution (labels at full res, projections at NeRF training res);
    # ``label_dir`` refreshes the per-camera labels from the original
    # SegmentationLabel tree; ``orig_img_dir`` additionally copies+scales the
    # original segmentation images for the overlays.
    scale_factor: float = 1.0
    label_dir: Optional[Path] = None
    orig_img_dir: Optional[Path] = None
    make_overlays: bool = False
    # Improvement over the reference (off by default for parity): a
    # subcluster that gathered NO label evidence from any camera (e.g. a
    # fully-occluded core) cannot testify to being its own instance; attach
    # it to the spatially nearest evidenced subcluster instead of counting
    # it as a singleton.
    attach_unlabeled: bool = False
    # Debug: count only this supercluster (-1 = all), ≙ merger.py:372 +
    # the single-cluster branch at :419-427.
    super_cluster_idx: int = -1


def copy_with_scaling(src: Path, dst: Path, scale_factor: float,
                      interpolation: int = cv2.INTER_NEAREST) -> None:
    """Copy an image, nearest-neighbour rescaled by ``scale_factor``
    (≙ copy_with_scaling, merger.py:145-158 — labels are instance-id images,
    so interpolation must never invent ids)."""
    src, dst = Path(src), Path(dst)
    if scale_factor == 1.0:
        if src.resolve() != dst.resolve():
            import shutil
            shutil.copy(src, dst)
        return
    img = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)
    if img is None:
        return
    new_size = (int(img.shape[1] * scale_factor),
                int(img.shape[0] * scale_factor))
    cv2.imwrite(str(dst), cv2.resize(img, new_size,
                                     interpolation=interpolation))


def prepare_camera_labels(sc_dir: Path, cfg: MergerConfig) -> None:
    """Refresh/rescale each camera's GT label image and emit overlay debug
    PNGs (≙ overly_mask_with_projection, merger.py:161-189).

    Per cam dir: the label image is (re)copied from ``cfg.label_dir`` (keyed
    by frame name, like the reference keys by the copied ``frame*.png``) and
    rescaled by ``cfg.scale_factor`` to the projection resolution; the union
    of the visibility projections is alpha-blended (0.5/0.5) over the
    segmentation frame into ``<sc_dir>/overlay/label_<frame>.png``.  Skipped
    when ``overlay/`` already exists (reference merger.py:392-393).
    """
    overlay_dir = sc_dir / "overlay"
    if overlay_dir.exists():
        return
    need_overlay = cfg.make_overlays or cfg.orig_img_dir is not None
    if need_overlay:
        overlay_dir.mkdir(parents=True, exist_ok=True)
    for cam_dir in sorted(sc_dir.glob("cam_*")):
        existing = sorted(cam_dir.glob("label_*.png"))
        frame_name = (existing[0].name[len("label_"):] if existing else None)
        if cfg.label_dir is not None:
            src = (Path(cfg.label_dir) / f"label_{frame_name}"
                   if frame_name else None)
            if src is None or not src.exists():
                # fall back to positional match: cam_<i> ↔ i-th label
                labels = sorted(Path(cfg.label_dir).glob("label_*.png"))
                idx = int(cam_dir.name.split("_")[-1])
                src = labels[idx] if idx < len(labels) else None
            if src is not None and src.exists():
                frame_name = src.name[len("label_"):]
                copy_with_scaling(src, cam_dir / src.name, cfg.scale_factor)
        elif cfg.scale_factor != 1.0 and existing:
            copy_with_scaling(existing[0], existing[0], cfg.scale_factor)
        if frame_name is None or not need_overlay:
            continue
        # segmentation frame: the original instance-colour image if given,
        # else a palette rendering of the label ids
        seg = None
        if cfg.orig_img_dir is not None:
            orig = Path(cfg.orig_img_dir) / frame_name
            if orig.exists():
                copy_with_scaling(orig, cam_dir / frame_name,
                                  cfg.scale_factor)
                seg = cv2.imread(str(cam_dir / frame_name))
        if seg is None:
            lab = cv2.imread(str(cam_dir / f"label_{frame_name}"),
                             cv2.IMREAD_GRAYSCALE)
            if lab is None:
                continue
            seg = _PALETTE[lab.astype(int) % len(_PALETTE)][..., ::-1].copy()
            seg[lab == 0] = 0
        merged = np.zeros_like(seg)
        for proj_path in sorted(
                cam_dir.glob(f"{cfg.visible_img_prefix}*.png")):
            proj = cv2.imread(str(proj_path))
            if proj is None or proj.shape != merged.shape:
                continue
            mask = proj.astype(bool)
            merged[mask] = proj[mask]
        overlaid = cv2.addWeighted(seg, 0.5, merged, 0.5, 0)
        cv2.imwrite(str(overlay_dir / f"label_{frame_name}"), overlaid)


def wo_occlusion_area(path: Path, thres: int
                      ) -> Tuple[float, Optional[Tuple[int, int, int, int]]]:
    """Occlusion-free projected area: threshold + largest contour area, and
    its bounding box (x0, y0, x1, y1) (merger.py:257-277).  Returns
    (EPS, None) when the projection is empty/too small."""
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        return EPS, None
    _, binary = cv2.threshold(img, thres, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return EPS, None
    cnt = max(contours, key=cv2.contourArea)
    area = cv2.contourArea(cnt)
    if area < 10:
        return EPS, None
    x, y, w, h = cv2.boundingRect(cnt)
    return area, (x, y, x + w, y + h)


def visible_projection_stats(cam_dir: Path, cid: int, bbox, thres: int,
                             cfg: MergerConfig) -> Tuple[float, int, float]:
    """(visible area, dominant GT label, label overlap area) within the
    occlusion-free bbox (merger.py:219-255).  The filled largest contour of
    the visibility projection is intersected with the GT label image; the
    label covering the most pixels wins (background label 0 → area 0)."""
    vis_path = cam_dir / f"{cfg.visible_img_prefix}_{cid}.png"
    label_paths = sorted(cam_dir.glob("label_*.png"))
    img = cv2.imread(str(vis_path), cv2.IMREAD_GRAYSCALE)
    if img is None or not label_paths:
        return EPS, 0, EPS
    x0, y0, x1, y1 = bbox
    img = img[y0:y1, x0:x1]
    _, binary = cv2.threshold(img, thres, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return EPS, 0, EPS
    cnt = max(contours, key=cv2.contourArea)
    mask = np.zeros_like(binary)
    cv2.drawContours(mask, [cnt], contourIdx=-1, color=255, thickness=-1)
    mask = mask.astype(bool)
    area = float(mask.sum())
    if area < 10:
        return EPS, 0, EPS
    if len(label_paths) > 1:
        import warnings
        warnings.warn(
            f"{cam_dir} holds {len(label_paths)} label_*.png; the projection "
            "layout is one label per camera dir — using the first "
            f"({label_paths[0].name}). Pass label_dir/scale_factor to "
            "refresh labels deterministically.")
    label_img = cv2.imread(str(label_paths[0]), cv2.IMREAD_GRAYSCALE)
    crop = label_img[y0:y1, x0:x1]
    if crop.shape != mask.shape:
        # label/projection resolution mismatch (or off-by-one from the
        # reference's int() rescale): score against the overlapping region,
        # zero-padding the rest (label 0 == background)
        padded = np.zeros(mask.shape, label_img.dtype)
        padded[:crop.shape[0], :crop.shape[1]] = \
            crop[:mask.shape[0], :mask.shape[1]]
        crop = padded
    labels = crop[mask]
    counted = sorted(((v, k) for k, v in Counter(labels.tolist()).items()),
                     reverse=True)
    label_area, label = counted[0]
    label_area = 0.0 if label == 0 else float(label_area)
    return area, int(label), label_area


def process_super_cluster(projection_dir: Path, n_subclusters: int,
                          cfg: MergerConfig) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-subcluster per-camera score vectors (merger.py:279-333)."""
    cam_dirs = sorted(projection_dir.glob("cam_*"))
    n_cams = max((int(d.name.split("_")[-1]) for d in cam_dirs), default=-1) + 1
    props: Dict[int, Dict[str, np.ndarray]] = {}
    for cid in range(n_subclusters):
        vis_area = EPS * np.ones(n_cams)
        wo_occ = EPS * np.ones(n_cams)
        overlap_area = EPS * np.ones(n_cams)
        overlap_label = np.zeros(n_cams)
        for cam_dir in cam_dirs[::cfg.frame_sampling_interval]:
            cam_id = int(cam_dir.name.split("_")[-1])
            area, bbox = wo_occlusion_area(
                cam_dir / f"{cfg.wo_occ_img_prefix}_{cid}.png",
                cfg.binary_threshold)
            wo_occ[cam_id] = area
            if bbox is None:
                vis_area[cam_id] = area
                continue
            v_area, label, l_area = visible_projection_stats(
                cam_dir, cid, bbox, cfg.binary_threshold, cfg)
            vis_area[cam_id] = v_area
            overlap_area[cam_id] = l_area
            overlap_label[cam_id] = label
        wo_occ_norm = wo_occ / wo_occ.max()
        if cfg.area_normalize:
            reliability = wo_occ_norm * (overlap_area / wo_occ)
        else:
            reliability = np.ones_like(wo_occ)
        props[cid] = {
            "visible_area": vis_area,
            "wo_occ_area": wo_occ,
            "wo_occ_area_norm": wo_occ_norm,
            "label": overlap_label,
            "label_overlap_area": overlap_area,
            "reliability": reliability,
        }
    return props


def calc_affinity(props: Dict[int, Dict[str, np.ndarray]]) -> np.ndarray:
    """Signed pairwise affinity (merger.py:335-355)."""
    n = len(props)
    affinity = np.zeros((n, n))
    for i in range(n):
        li, ri = props[i]["label"], props[i]["reliability"]
        for j in range(i + 1, n):
            lj, rj = props[j]["label"], props[j]["reliability"]
            same = (li == lj) & (li != 0) & (lj != 0)
            diff = (li != lj) & (li != 0) & (lj != 0)
            a = ri[same] @ rj[same] - ri[diff] @ rj[diff]
            affinity[i, j] = affinity[j, i] = a
    return affinity


def _attach_unlabeled(props: Dict[int, Dict[str, np.ndarray]],
                      affinity: np.ndarray, labels: np.ndarray, info: dict
                      ) -> Tuple[int, np.ndarray]:
    """Reassign evidence-free subclusters — no camera evidence at all, or
    no affinity (positive or negative) with any other subcluster — to the
    component of the nearest evidenced subcluster; relabel components
    densely and return the corrected (count, labels)."""
    if affinity.shape[0] <= 1:
        return len(set(labels.tolist())), labels
    evidence = {cid: int((p["label"] != 0).sum()) for cid, p in props.items()}
    strongest = max(evidence, key=evidence.get)
    # anchors: nodes with actual (dis)agreement evidence, plus the node the
    # cameras saw best — everything else with a zero affinity row attaches
    anchors = {cid for cid in props if np.any(affinity[cid] != 0)}
    anchors.add(strongest)
    floaters = [cid for cid in props if cid not in anchors]
    if not floaters:
        return len(set(labels.tolist())), labels
    centroids = {cid: np.mean(info["pcd"][cid], axis=0)
                 for cid in info["pcd"]}
    labels = labels.copy()
    for cid in floaters:
        nearest = min(anchors, key=lambda e: float(
            np.linalg.norm(centroids[cid] - centroids[e])))
        labels[cid] = labels[nearest]
    uniq = {l: i + 1 for i, l in enumerate(sorted(set(labels.tolist())))}
    labels = np.array([uniq[l] for l in labels.tolist()], dtype=labels.dtype)
    return len(uniq), labels


@dataclasses.dataclass
class CountResult:
    total_count: int
    per_super_cluster: List[int]
    labels: List[np.ndarray]          # per supercluster, per subcluster
    affinities: List[np.ndarray]


def count_instances(projection_dir: Path, super_cluster_info: np.ndarray,
                    cfg: MergerConfig = MergerConfig()) -> CountResult:
    """Count crop instances across all superclusters (merger.py:389-445):
    thread pool over superclusters, per-cluster partitioning, global label
    offsetting."""
    projection_dir = Path(projection_dir)
    n_super = min(cfg.max_super_clusters, len(super_cluster_info))
    if n_super == 0:
        print("Total bool: 0")
        return CountResult(total_count=0, per_super_cluster=[], labels=[],
                           affinities=[])
    n_sub = super_cluster_info[0]["aabb"].shape[0]

    def handle(idx: int):
        sc_dir = projection_dir / f"super_cluster_{idx}"
        if (cfg.label_dir is not None or cfg.scale_factor != 1.0
                or cfg.make_overlays or cfg.orig_img_dir is not None):
            prepare_camera_labels(sc_dir, cfg)
        props = process_super_cluster(sc_dir, n_sub, cfg)
        affinity = calc_affinity(props)
        n_comp, labels = partition(affinity, cfg.graph_partition)
        if cfg.attach_unlabeled:
            n_comp, labels = _attach_unlabeled(
                props, affinity, labels, super_cluster_info[idx])
        return n_comp, labels, affinity

    if cfg.super_cluster_idx >= 0:
        if cfg.super_cluster_idx >= n_super:
            raise ValueError(f"super_cluster_idx={cfg.super_cluster_idx} "
                             f"out of range (have {n_super} superclusters)")
        indices = [cfg.super_cluster_idx]
    else:
        indices = list(range(n_super))
    with ThreadPoolExecutor(max_workers=cfg.n_thread) as pool:
        outputs = list(pool.map(handle, indices))

    total = 0
    counts, labels_list, affinities = [], [], []
    for n_comp, labels, aff in outputs:
        labels_list.append(labels + total)
        counts.append(n_comp)
        affinities.append(aff)
        total += n_comp
    print(f"Total bool: {total}")
    return CountResult(total_count=total, per_super_cluster=counts,
                       labels=labels_list, affinities=affinities)


_PALETTE = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]],
    np.uint8)


def write_instance_cloud(path: Path, super_cluster_info: np.ndarray,
                         result: CountResult) -> None:
    """Instance-labelled result cloud ≙ full_tree_seg_result.ply
    (merger.py:446-460)."""
    pts, cols = [], []
    for s, labels in enumerate(result.labels):
        info = super_cluster_info[s]
        for cid, p in info["pcd"].items():
            lbl = int(labels[cid])
            pts.append(p)
            cols.append(np.tile(_PALETTE[lbl % len(_PALETTE)], (len(p), 1)))
    if pts:
        write_ply(path, np.concatenate(pts), np.concatenate(cols))
