"""Chunked full-image renderer (counterpart of ``make_render_fn`` in
``cropnerf_tpu/train/step.py``).  The training step comes with the
training slice."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.cameras import Cameras, generate_rays, near_far_collider
from ..core.rays import RayBundle
from ..models.config import TrainConfig
from ..models.model import CropNeRFParams, forward

RENDER_KEYS = ("rgb", "accumulation", "depth", "semantics",
               "semantics_colormap")


def make_render_fn(cfg: TrainConfig, background: Optional[str] = None,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``render(params, cameras, cam_index, height, width)`` → image-shaped
    outputs [H, W, C].  The pixels are padded to a whole number of
    ``eval_num_rays_per_chunk`` chunks, so every chunk has one shape, and
    rendered one chunk at a time."""
    m = cfg.model
    chunk = cfg.eval_num_rays_per_chunk

    @torch.no_grad()
    def render(params: CropNeRFParams, cameras: Cameras, cam_index: int,
               height: int, width: int) -> Dict[str, torch.Tensor]:
        device = cameras.c2w.device
        ys, xs = torch.meshgrid(torch.arange(height, device=device),
                                torch.arange(width, device=device),
                                indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
        n = xs.shape[0]
        n_pad = (-n) % chunk
        zeros = torch.zeros((n_pad,), dtype=xs.dtype, device=device)
        xs, ys = torch.cat([xs, zeros]), torch.cat([ys, zeros])
        cam = torch.full_like(xs, cam_index)

        pieces = {k: [] for k in RENDER_KEYS}
        for start in range(0, xs.shape[0], chunk):
            cx = cam[start:start + chunk]
            px, py = xs[start:start + chunk], ys[start:start + chunk]
            origins, dirs = generate_rays(cameras, cx, px, py)
            ones = torch.ones_like(px, dtype=torch.float32)
            rb = RayBundle(origins=origins, directions=dirs,
                           nears=torch.zeros_like(ones), fars=ones,
                           camera_idx=cx)
            rb = near_far_collider(rb, m.near_plane, m.far_plane)
            out = forward(params, rb, m, train=False, background=background,
                          compute_dtype=compute_dtype)
            for k in RENDER_KEYS:
                pieces[k].append(out[k])
        return {k: torch.cat(v)[:n].reshape(height, width, -1)
                for k, v in pieces.items()}

    return render
