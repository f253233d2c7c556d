"""Image + semantic-mask loading into stacked uint8 arrays.

The port's own copy of ``cropnerf_tpu/data/dataset.py`` (numpy and PIL).

Equivalent of ``FruitDataset`` (the reference's crop_nerf/fruit_nerf/data/
cotton_dataset.py:34-151): images loaded and downscaled, semantic masks
grayscale-thresholded at 3 into a binary {0,1} ``fruit_mask``.  Output feeds
:func:`cropnerf_tpu_torch.data.databank.build_pixel_bank`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
from PIL import Image

from .dataparser import DataparserOutputs

SEMANTIC_THRESHOLD = 3   # cotton_dataset.py:36: grayscale > 3 → crop


def resolve_semantic_threshold(path: Path, threshold) -> int:
    """Resolve a threshold spec to an int for one label file.

    ``"fruit"`` selects the alternate ``FruitDataset`` per-extension dispatch
    (data/fruit_dataset.py:48-53): ``.jpg``/``.jpeg`` labels binarise at 125
    (JPEG block noise around the mask edges), anything else is an exact
    {0, 255} (or {0, 1}) label image → any nonzero value is crop."""
    if threshold == "fruit":
        suffix = Path(path).suffix.lower()
        return 125 if suffix in (".jpg", ".jpeg") else 0
    return int(threshold)


def load_image(path: Path, downscale: int = 1) -> np.ndarray:
    """RGB uint8 [H, W, 3]; integer-factor downscale by PIL bilinear resize
    (the reference's ns downscale pipeline pre-generates images_2/ etc.; we
    resize on load)."""
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if downscale > 1:
        img = img.resize((img.width // downscale, img.height // downscale),
                         Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_semantic_mask(path: Path, downscale: int = 1,
                       shape: Tuple[int, int] | None = None,
                       threshold: int | str = SEMANTIC_THRESHOLD) -> np.ndarray:
    """Binary {0,1} uint8 mask [H, W] (get_object_semantics,
    cotton_dataset.py:34-39: grayscale, threshold > 3; pass
    ``threshold="fruit"`` for the alternate FruitDataset per-extension
    dispatch, data/fruit_dataset.py:31-57, or an explicit int).  Missing
    files yield an all-zero mask (datasets without segmentation still
    train RGB)."""
    if not Path(path).exists():
        assert shape is not None
        return np.zeros(shape, np.uint8)
    threshold = resolve_semantic_threshold(path, threshold)
    img = Image.open(path).convert("L")
    if downscale > 1:
        img = img.resize((img.width // downscale, img.height // downscale),
                         Image.NEAREST)
    arr = np.asarray(img)
    return (arr > threshold).astype(np.uint8)


def load_split(outputs: DataparserOutputs,
               semantic_threshold: int | str = SEMANTIC_THRESHOLD,
               indices=None) -> Tuple[np.ndarray, np.ndarray]:
    """Load all images + masks of a split → ([N,H,W,3] u8, [N,H,W] u8).

    All frames must share one post-downscale size (the dataparser rescales
    intrinsics consistently; mixed sizes would break the flat pixel bank).
    ``indices`` selects a frame subset (may repeat) — multi-host runs load
    only their local shard of the padded frame list.
    """
    ds = outputs.downscale_factor
    image_paths = list(outputs.image_paths)
    semantic_paths = list(outputs.semantic_paths)
    if indices is not None:
        image_paths = [image_paths[i] for i in indices]
        semantic_paths = [semantic_paths[i] for i in indices]
    images, masks = [], []
    for img_path, sem_path in zip(image_paths, semantic_paths):
        img = load_image(img_path, ds)
        images.append(img)
        masks.append(load_semantic_mask(sem_path, ds, img.shape[:2],
                                        semantic_threshold))
    shapes = {im.shape for im in images}
    assert len(shapes) == 1, f"mixed image sizes after downscale: {shapes}"
    return np.stack(images), np.stack(masks)
