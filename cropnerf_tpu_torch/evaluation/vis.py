"""Headless cluster / instance / affinity visualisation.

The port's own copy of ``cropnerf_tpu/evaluation/vis.py`` (numpy, PIL and
matplotlib): the trainer's eval-image PNGs come from ``save_eval_images``.

Equivalent of the reference's Open3D window viewers
(the reference's crop_nerf/evaluation/vis_semantic_seg.py:39-178,
segmentation/segmenter.py:187-204, merger.py:77-101
``draw_graph_from_adjacency_matrix``) — re-targeted at a headless
environment: everything renders to PNG via matplotlib (Agg).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PALETTE = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]],
    np.float32) / 255.0


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_cluster_views(points: np.ndarray, labels: np.ndarray,
                       out_path: Path, title: str = "clusters",
                       max_points: int = 100_000) -> Path:
    """Three orthographic scatter views (xy/xz/yz) coloured by cluster label
    (noise label -1 in grey)."""
    plt = _plt()
    if len(points) > max_points:
        sel = np.random.RandomState(0).choice(len(points), max_points,
                                              replace=False)
        points, labels = points[sel], labels[sel]
    colors = np.where(labels[:, None] >= 0,
                      _PALETTE[np.abs(labels) % len(_PALETTE)],
                      np.full((1, 3), 0.5))
    fig, axes = plt.subplots(1, 3, figsize=(13, 4.5))
    for ax, (i, j, name) in zip(axes, [(0, 1, "xy"), (0, 2, "xz"),
                                       (1, 2, "yz")]):
        ax.scatter(points[:, i], points[:, j], c=colors, s=1, linewidths=0)
        ax.set_title(f"{title} ({name})")
        ax.set_aspect("equal")
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def save_instance_views(super_cluster_info: Sequence[dict],
                        instance_labels: Sequence[np.ndarray],
                        out_path: Path) -> Path:
    """Instance-coloured result cloud views (≙ show_pcd of the final
    segmentation, merger.py:103-144)."""
    pts, labs = [], []
    for info, labels in zip(super_cluster_info, instance_labels):
        for cid, pc in info["pcd"].items():
            pts.append(pc)
            labs.append(np.full(len(pc), int(labels[cid])))
    return save_cluster_views(np.concatenate(pts), np.concatenate(labs),
                              out_path, title="instances")


def save_affinity_graph(affinity: np.ndarray, out_path: Path,
                        labels: Optional[np.ndarray] = None) -> Path:
    """Co-occurrence graph render: green = positive affinity, red = negative,
    width ∝ |weight| (≙ draw_graph_from_adjacency_matrix, merger.py:77-101)."""
    plt = _plt()
    n = affinity.shape[0]
    angles = 2 * np.pi * np.arange(n) / max(n, 1)
    xy = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    fig, ax = plt.subplots(figsize=(5, 5))
    for i in range(n):
        for j in range(i + 1, n):
            w = affinity[i, j]
            if w == 0:
                continue
            ax.plot(xy[[i, j], 0], xy[[i, j], 1],
                    color="green" if w > 0 else "red",
                    linewidth=min(6.0, 0.5 + abs(w)), zorder=1)
    node_colors = (_PALETTE[np.asarray(labels, int) % len(_PALETTE)]
                   if labels is not None else
                   np.tile(_PALETTE[0], (n, 1)))
    ax.scatter(xy[:, 0], xy[:, 1], s=600, c=node_colors, zorder=2,
               edgecolors="black")
    for i in range(n):
        ax.annotate(str(i), xy[i], ha="center", va="center", zorder=3)
    ax.set_axis_off()
    ax.set_aspect("equal")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def apply_colormap(x: np.ndarray, cmap: str = "turbo",
                   lo: Optional[float] = None,
                   hi: Optional[float] = None) -> np.ndarray:
    """Scalar image [H, W] → uint8 RGB [H, W, 3] (≙ nerfstudio colormaps
    used by the reference's eval images, fruit_nerf.py:653-683)."""
    x = np.asarray(x, np.float32)
    lo = float(x.min()) if lo is None else lo
    hi = float(x.max()) if hi is None else hi
    t = (x - lo) / max(hi - lo, 1e-12)
    t = np.clip(t, 0.0, 1.0)
    _plt()
    import matplotlib
    rgba = matplotlib.colormaps[cmap](t)
    return (rgba[..., :3] * 255).astype(np.uint8)


def save_eval_images(out_dir: Path, outputs: dict, gt_rgb: np.ndarray,
                     gt_mask: np.ndarray) -> Path:
    """Eval-image artifact strip set (≙ get_image_metrics_and_images,
    fruit_nerf.py:647-702): gt|pred RGB strip, accumulation + depth
    colormaps, semantic sigmoid map (+ 0.9-binarised) vs the GT mask.

    ``outputs``: the render dict (rgb/accumulation/depth/semantics_colormap
    as [H, W, C] arrays).  Writes PNGs under ``out_dir``.
    """
    from PIL import Image
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    pred = np.clip(np.asarray(outputs["rgb"], np.float32), 0, 1)
    gt = np.asarray(gt_rgb, np.float32)
    if gt.max() > 1:
        gt = gt / 255.0
    strip = np.concatenate([gt, pred], axis=1)
    Image.fromarray((strip * 255).astype(np.uint8)).save(out_dir / "img.png")

    acc = np.asarray(outputs["accumulation"])[..., 0]
    Image.fromarray(apply_colormap(acc, lo=0.0, hi=1.0)).save(
        out_dir / "accumulation.png")
    depth = np.asarray(outputs["depth"])[..., 0]
    Image.fromarray(apply_colormap(depth)).save(out_dir / "depth.png")

    sem = np.asarray(outputs["semantics_colormap"])[..., 0]
    sem_strip = np.concatenate(
        [sem, (sem >= 0.9).astype(np.float32),
         np.asarray(gt_mask, np.float32)], axis=1)
    Image.fromarray((np.clip(sem_strip, 0, 1) * 255).astype(np.uint8)).save(
        out_dir / "semantics.png")
    return out_dir


def save_projection_overlay(label_img: np.ndarray, projection_img: np.ndarray,
                            out_path: Path) -> Path:
    """Blend a visibility projection over the GT label image for debugging
    (≙ overly_mask_with_projection, merger.py:161-189)."""
    from PIL import Image
    lab_rgb = _PALETTE[label_img.astype(int) % len(_PALETTE)] * 255
    lab_rgb[label_img == 0] = 0
    proj = np.repeat(projection_img[..., None].astype(np.float32), 3, axis=-1)
    if proj.max() > 1:
        proj = proj / 255.0
    blend = np.clip(0.5 * lab_rgb + 0.5 * proj * 255, 0, 255).astype(np.uint8)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(blend).save(out_path)
    return out_path
