"""Dependency-free fallback mask segmenter (GroundedSAM stand-in).

The port's own copy of ``cropnerf_tpu/data/autoseg.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

The reference's dataset builder generates per-class binary fruit masks with
GroundedSAM — GroundingDINO box prompts + SAM-HQ masks per box, masks
covering >20% of the image dropped, union written as a binary mask png
(the reference's crop_nerf/fruit_nerf/fruit_nerf_dataset.py:51-198).  Those
external torch/CUDA models are out of scope in this zero-egress image
(SURVEY §2.3 N9), but the *pipeline step* they implement — images in,
per-class binary masks out, wired into transforms.json — is reproduced here
with classical colour segmentation so the dataset builder can run end to
end without any downloaded model:

  * foreground prior: an explicit reference colour (``color=``), or
    ``k``-means over pixel colours (the in-repo native kmeans backend,
    counting/clustering.py) with the foreground cluster picked by colour
    distance — the stand-in for the text prompt;
  * component filtering mirrors the reference's post-SAM rules: connected
    components covering more than ``max_mask_fraction`` of the image are
    dropped (fruit_nerf_dataset.py:172-177), tiny specks below
    ``min_area`` px are dropped, and a morphological close/open cleans
    ragged edges;
  * output: ``mask_<name>.png`` binary images (255 foreground / 0
    background — the format fruit_nerf_dataset.py:180-198 writes and
    data/dataset.py consumes), optionally registered as per-frame
    ``semantic_path`` entries in ``transforms.json`` exactly like the
    reference's ``_save_transforms`` (:364-373).

This is an honest classical fallback, not a replacement for prompt-based
segmentation quality on real imagery; on real datasets, precomputed masks
(3DCotton ships ``segmentation_object/``) or an external GroundedSAM run
remain the high-quality path.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image


@dataclass(frozen=True)
class AutoSegConfig:
    """Knobs for the colour-prior segmenter."""
    color: Optional[Tuple[int, int, int]] = None  # foreground prior (RGB)
    color_tol: float = 60.0       # max RGB distance to the prior
    k: int = 3                    # kmeans clusters when no explicit prior
    max_mask_fraction: float = 0.2  # drop components >20% of the image
                                    # (fruit_nerf_dataset.py:172-177)
    min_area: int = 16            # drop specks below this many pixels
    morph_radius: int = 1         # close/open structuring-element radius


def _connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Label 4-connected components; cv2 when present, else scipy."""
    try:
        import cv2
        n, labels = cv2.connectedComponents(mask.astype(np.uint8),
                                            connectivity=4)
        return labels, n
    except ImportError:
        from scipy import ndimage
        labels, n = ndimage.label(mask)
        return labels, n + 1


def _morph_close_open(mask: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return mask
    try:
        import cv2
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                           (2 * radius + 1, 2 * radius + 1))
        m = cv2.morphologyEx(mask.astype(np.uint8), cv2.MORPH_CLOSE, kernel)
        return cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel).astype(bool)
    except ImportError:
        from scipy import ndimage
        st = ndimage.generate_binary_structure(2, 2)
        m = ndimage.binary_closing(mask, st, iterations=radius)
        return ndimage.binary_opening(m, st, iterations=radius)


def _foreground_by_kmeans(img: np.ndarray, cfg: AutoSegConfig) -> np.ndarray:
    """Cluster pixel colours; foreground = cluster(s) nearest the prior, or
    (priorless) every cluster except the one owning the image border —
    the background touches the frame in any orbit capture."""
    from ..counting.clustering import kmeans
    h, w = img.shape[:2]
    flat = img.reshape(-1, 3).astype(np.float64)
    labels = kmeans(flat, cfg.k, seed=0).reshape(h, w)
    centers = np.stack([flat[labels.ravel() == i].mean(axis=0)
                        if np.any(labels.ravel() == i) else np.full(3, 1e9)
                        for i in range(cfg.k)])
    if cfg.color is not None:
        d = np.linalg.norm(centers - np.asarray(cfg.color, np.float64),
                           axis=1)
        fg = d <= cfg.color_tol
        if not fg.any():
            fg[np.argmin(d)] = True
    else:
        border = np.concatenate([labels[0], labels[-1],
                                 labels[:, 0], labels[:, -1]])
        bg_label = np.bincount(border, minlength=cfg.k).argmax()
        fg = np.ones(cfg.k, bool)
        fg[bg_label] = False
    return fg[labels]


def segment_image(img: np.ndarray, cfg: AutoSegConfig = AutoSegConfig()
                  ) -> np.ndarray:
    """RGB uint8 [H,W,3] → binary foreground mask [H,W] bool.

    Explicit colour prior → direct distance threshold; otherwise kmeans
    colour clustering.  Then the reference's component rules (>20% drop,
    speck drop) and a morphological clean-up.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3]
    if cfg.color is not None and cfg.k <= 1:
        d = np.linalg.norm(img.astype(np.float64)
                           - np.asarray(cfg.color, np.float64), axis=-1)
        raw = d <= cfg.color_tol
    else:
        raw = _foreground_by_kmeans(img, cfg)
    raw = _morph_close_open(raw, cfg.morph_radius)
    labels, n = _connected_components(raw)
    if n <= 1:
        return np.zeros(img.shape[:2], bool)
    areas = np.bincount(labels.ravel(), minlength=n)
    total = img.shape[0] * img.shape[1]
    keep = np.zeros(n, bool)
    for c in range(1, n):
        if areas[c] < cfg.min_area:
            continue
        if areas[c] > cfg.max_mask_fraction * total:
            continue                      # ≙ fruit_nerf_dataset.py:172-177
        keep[c] = True
    return keep[labels]


def segment_dir(image_dir: Path, out_dir: Path,
                cfg: AutoSegConfig = AutoSegConfig(),
                patterns: Sequence[str] = ("*.png", "*.jpg", "*.jpeg"),
                transforms_path: Optional[Path] = None) -> int:
    """Segment every image in ``image_dir`` → ``out_dir/mask_<name>.png``
    (binary 255/0, the fruit_nerf_dataset.py:180-198 output format).

    With ``transforms_path``, each frame whose ``file_path`` stem matches a
    segmented image gains a ``semantic_path`` entry pointing at its mask
    (and the top level a ``semantics`` classes stub), mirroring the
    reference's ``_save_transforms`` injection (:364-373).
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    files: list[Path] = []
    for pat in patterns:
        files += sorted(Path(image_dir).glob(pat))
    for p in files:
        img = np.asarray(Image.open(p).convert("RGB"))
        mask = segment_image(img, cfg)
        name = f"mask_{p.stem}.png"
        Image.fromarray((mask.astype(np.uint8)) * 255).save(out_dir / name)
        written[p.stem] = name
    if transforms_path is not None and written:
        transforms_path = Path(transforms_path)
        meta = json.loads(transforms_path.read_text())
        rel = out_dir.name
        for frame in meta.get("frames", []):
            stem = Path(frame.get("file_path", "")).stem
            if stem in written:
                frame["semantic_path"] = f"{rel}/{written[stem]}"
        meta.setdefault("semantics", {"classes": ["background", "fruit"]})
        transforms_path.write_text(json.dumps(meta, indent=2))
    return len(written)
