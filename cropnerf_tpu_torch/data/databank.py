"""Pixel bank: the whole training set resident on the card (counterpart of
``cropnerf_tpu/data/databank.py``).  Images and masks live as flat uint8
tensors on the device; the training step samples pixels, gathers them and
generates rays there, with no host-to-device copy in steady state.

The sharded bank splits the padded image stack over the ranks at image
granularity: rank r holds images [r·I/N, (r+1)·I/N) and the full padded
camera set, and samples its rays from its own rows (the reference's
per-rank datamanager).  Each rank loads only its own images from disk
(:func:`process_image_range`)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.cameras import Cameras
from ..device import resolve_device


@dataclasses.dataclass
class PixelBank:
    """rgb [P, 3] uint8 and mask [P] uint8 with P = images·H·W; camera
    ``image_offset + i`` owns pixels [i·H·W, (i+1)·H·W).  A replicated bank
    holds every image (offset 0); a sharded bank holds one rank's images
    beside the whole camera set."""

    rgb: torch.Tensor
    mask: torch.Tensor
    cameras: Cameras
    height: int = 0
    width: int = 0
    image_offset: int = 0

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


# -- sharded bank -------------------------------------------------------------


def padded_num_images(num_images: int, num_shards: int) -> int:
    """Images are the shard granularity (every image holds H*W pixels), so
    the global image count is padded up to a multiple of the mesh size."""
    return ((num_images + num_shards - 1) // num_shards) * num_shards


def pad_cameras(cameras: Cameras, num_shards: int) -> Cameras:
    """Camera set padded to the sharding granularity by wrapping around
    (``i % n``): duplicated frames bias pixel sampling negligibly and keep
    every shard the same shape."""
    n = cameras.num_cameras
    n_pad = padded_num_images(n, num_shards)
    if n_pad == n:
        return cameras
    sel = torch.arange(n_pad, device=cameras.c2w.device) % n
    return Cameras(
        c2w=cameras.c2w[sel], fx=cameras.fx[sel], fy=cameras.fy[sel],
        cx=cameras.cx[sel], cy=cameras.cy[sel], width=cameras.width[sel],
        height=cameras.height[sel],
        distortion=(cameras.distortion[sel]
                    if cameras.distortion is not None else None))


def pad_images_for_sharding(images: np.ndarray, masks: np.ndarray,
                            cameras: Cameras, num_shards: int):
    """Repeat trailing images (and their cameras) so the stack divides the
    mesh evenly."""
    n = images.shape[0]
    sel = np.arange(padded_num_images(n, num_shards)) % n
    return images[sel], masks[sel], pad_cameras(cameras, num_shards)


def process_image_range(num_images_padded: int, mesh) -> tuple:
    """[lo, hi) slice of the padded global image stack this rank must load
    (per-rank input pipelines feed only their shard)."""
    per = num_images_padded // mesh.size
    lo = mesh.rank * per
    return lo, lo + per


def build_sharded_pixel_bank(local_images: np.ndarray,
                             local_masks: np.ndarray, cameras: Cameras,
                             mesh) -> PixelBank:
    """This rank's shard of the bank, on ``mesh.device``.

    ``local_images``/``local_masks``: this rank's contiguous slice of the
    padded global stack (:func:`process_image_range`).  ``cameras``: the
    full padded global camera set, on the rank's device.  The global image
    count (``cameras.num_cameras``) must divide the mesh size.  The ranks'
    row ranges are gathered and must tile the global rows in rank order,
    since the training step's global camera id is the local one plus
    ``image_offset``."""
    n_global = cameras.num_cameras
    assert n_global % mesh.size == 0, (
        f"{n_global} images over {mesh.size} devices: pad first "
        "(pad_images_for_sharding)")
    n, h, w, _ = local_images.shape
    assert n * mesh.size == n_global, (
        f"each of {mesh.size} ranks must hold {n_global // mesh.size} "
        f"images, got {n}")
    lo, _ = process_image_range(n_global, mesh)
    rows = n * h * w
    span = (lo * h * w, lo * h * w + rows)
    if mesh.size > 1 and mesh.cpu_group is not None:
        import torch.distributed as dist
        spans = [None] * mesh.size
        dist.all_gather_object(spans, span, group=mesh.cpu_group)
        assert spans[0][0] == 0 and spans[-1][1] == n_global * h * w and \
            all(a[1] == b[0] for a, b in zip(spans, spans[1:])), (
            f"rank {mesh.rank}: the ranks own rows {spans}, which do not "
            f"tile [0, {n_global * h * w}) in rank order; the sharded "
            "bank's camera-id arithmetic does not support this layout")
    bank = build_pixel_bank(local_images, local_masks, cameras, mesh.device)
    bank.image_offset = lo
    return bank
