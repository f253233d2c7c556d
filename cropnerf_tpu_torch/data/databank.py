"""Pixel bank: the whole training set resident on the card (counterpart of
``cropnerf_tpu/data/databank.py``).  Images and masks live as flat uint8
tensors on the device; the training step samples pixels, gathers them and
generates rays there, with no host-to-device copy in steady state.  The
bank sharded over several cards comes with the multi-GPU slice."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.cameras import Cameras
from ..device import resolve_device


@dataclasses.dataclass
class PixelBank:
    """rgb [P, 3] uint8 and mask [P] uint8 with P = num_images·H·W; camera
    i owns pixels [i·H·W, (i+1)·H·W)."""

    rgb: torch.Tensor
    mask: torch.Tensor
    cameras: Cameras
    height: int = 0
    width: int = 0

    @property
    def num_pixels(self) -> int:
        return self.rgb.shape[0]

    @property
    def num_images(self) -> int:
        return self.cameras.num_cameras


def build_pixel_bank(images: np.ndarray, masks: np.ndarray, cameras: Cameras,
                     device: torch.device | str = "cuda") -> PixelBank:
    """images [N, H, W, 3] uint8, masks [N, H, W] uint8 {0, 1} → a bank on
    ``device`` (the cameras are expected there already)."""
    device = resolve_device(device)
    n, h, w, _ = images.shape
    return PixelBank(
        rgb=torch.from_numpy(np.ascontiguousarray(images).reshape(-1, 3)).to(device),
        mask=torch.from_numpy(np.ascontiguousarray(masks).reshape(-1)).to(device),
        cameras=cameras, height=h, width=w)


def decode_pixel_index(idx: torch.Tensor, height: int, width: int):
    """Flat pixel index → (camera, x, y)."""
    hw = height * width
    cam = idx // hw
    rem = idx % hw
    return cam, rem % width, rem // width
