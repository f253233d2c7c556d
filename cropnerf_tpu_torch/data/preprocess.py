"""Preprocessing utilities: instance-colour PNG → label image, mask
conversion, rescaling.

The port's own copy of ``cropnerf_tpu/data/preprocess.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Equivalents of the reference's crop_nerf/fruit_nerf/utils/
convert_segmentation_img_to_label.py:8-36, utils/rescale.py, and
data/thick_contour_extractor.py:12-33.  COLMAP pose estimation and
GroundedSAM mask generation (fruit_nerf_dataset.py) are external-model /
external-binary preprocessing steps the framework consumes the *outputs* of
(transforms.json + mask images), exactly like the reference's dataset layout
(README.md:82-110).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
from PIL import Image


def convert_segmentation_img_to_label(img: np.ndarray
                                      ) -> Tuple[np.ndarray, Dict]:
    """Instance-colour image [H,W,3] → uint8 label image (background 0,
    instances 1..N) + colour→label mapping (vectorised, vs. the reference's
    per-pixel dict loop)."""
    flat = img.reshape(-1, img.shape[-1])
    colors, inv = np.unique(flat, axis=0, return_inverse=True)
    # background = black (or the most common colour if no pure black exists)
    bg = np.where((colors == 0).all(axis=1))[0]
    bg_idx = int(bg[0]) if len(bg) else int(np.bincount(inv).argmax())
    remap = np.zeros(len(colors), np.uint8)
    nxt = 1
    for i in range(len(colors)):
        if i == bg_idx:
            continue
        remap[i] = nxt
        nxt += 1
    labels = remap[inv].reshape(img.shape[:2])
    mapping = {tuple(int(x) for x in colors[i]): int(remap[i])
               for i in range(len(colors))}
    return labels, mapping


def convert_segmentation_dir(seg_dir: Path, out_dir: Path,
                             pattern: str = "*.png") -> int:
    """Batch-convert SegmentationObject images → SegmentationLabel
    ``label_<name>.png`` files (README.md:116 step 1)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(Path(seg_dir).glob(pattern)):
        img = np.asarray(Image.open(p).convert("RGB"))
        labels, _ = convert_segmentation_img_to_label(img)
        Image.fromarray(labels).save(out_dir / f"label_{p.name}")
        n += 1
    return n


def binary_mask_from_instance_img(img: np.ndarray,
                                  threshold: int = 3) -> np.ndarray:
    """Instance/colour segmentation image → binary semantic mask {0, 255}
    (any non-background pixel is 'crop'; cotton_dataset.py threshold)."""
    gray = img.mean(axis=-1) if img.ndim == 3 else img
    return np.where(gray > threshold, 255, 0).astype(np.uint8)


def boundary_mask(label_img: np.ndarray, thickness: int = 3) -> np.ndarray:
    """Thick instance-boundary mask via morphological gradient per instance
    (data/thick_contour_extractor.py:12-33)."""
    import cv2
    kernel = np.ones((thickness, thickness), np.uint8)
    out = np.zeros(label_img.shape[:2], np.uint8)
    for lbl in np.unique(label_img):
        if lbl == 0:
            continue
        m = (label_img == lbl).astype(np.uint8)
        grad = cv2.morphologyEx(m, cv2.MORPH_GRADIENT, kernel)
        out[grad > 0] = 255
    return out


def rescale_images(src_dir: Path, dst_dir: Path, factor: int,
                   pattern: str = "*.png", nearest: bool = False) -> int:
    """Downscale a directory of images by an integer factor
    (utils/rescale.py; nearest for label/mask images)."""
    dst_dir = Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(Path(src_dir).glob(pattern)):
        img = Image.open(p)
        img = img.resize((img.width // factor, img.height // factor),
                         Image.NEAREST if nearest else Image.BILINEAR)
        img.save(dst_dir / p.name)
        n += 1
    return n
