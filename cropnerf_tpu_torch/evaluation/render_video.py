"""Orbit-camera video rendering + camera-pose export (counterpart of
``cropnerf_tpu/evaluation/render_video.py``).

``render_orbit_video`` renders frames from cameras on a circle with the
chunked renderer (``train/step.py`` ``make_render_fn``) on the parameters'
device and writes an mp4 through imageio, or a directory of PNG frames
where no video backend is available.  ``export_camera_poses`` writes
transforms_train.json / transforms_eval.json with the trained camera-opt
deltas applied to the train poses.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.cameras import Cameras
from ..models.camera_opt import exp_so3
from ..models.config import TrainConfig
from ..models.model import CropNeRFParams
from ..train.step import make_render_fn


def orbit_cameras(n_frames: int, radius: float = 1.2, height: float = 0.3,
                  center=(0.0, 0.0, 0.0), focal: float = 400.0,
                  width: int = 400, image_height: int = 400,
                  device: torch.device | str = "cuda") -> Cameras:
    """Cameras on a circle looking at ``center`` (OpenGL convention), on
    ``device``."""
    c2ws = []
    ctr = np.asarray(center, np.float64)
    for i in range(n_frames):
        theta = 2 * np.pi * i / n_frames
        eye = ctr + np.array([radius * np.cos(theta),
                              radius * np.sin(theta), height])
        fwd = ctr - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        R = np.stack([right, true_up, -fwd], axis=1)
        c2ws.append(np.concatenate([R, eye[:, None]], axis=1))
    n = n_frames

    def full(v, dtype=torch.float32):
        return torch.full((n,), v, dtype=dtype, device=device)

    return Cameras(
        c2w=torch.from_numpy(np.stack(c2ws).astype(np.float32)).to(device),
        fx=full(focal), fy=full(focal),
        cx=full(width / 2.0), cy=full(image_height / 2.0),
        width=full(width, torch.int32),
        height=full(image_height, torch.int32))


def render_orbit_video(params: CropNeRFParams, cfg: TrainConfig,
                       output_path: Path, n_frames: int = 60,
                       radius: float = 1.2, center=(0.0, 0.0, 0.0),
                       size: int = 400, focal: float = 400.0, fps: int = 24,
                       channel: str = "rgb") -> Path:
    """Render an orbit around the scene → mp4 (falls back to a PNG frame
    directory if no video backend is available)."""
    cams = orbit_cameras(n_frames, radius=radius, center=center,
                         focal=focal, width=size, image_height=size,
                         device=params.camera_opt.device)
    render = make_render_fn(cfg)
    frames = []
    for i in range(n_frames):
        out = render(params, cams, i, size, size)
        img = out[channel].cpu().numpy()
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(output_path, frames, fps=fps)
    except Exception:
        frame_dir = output_path.with_suffix("")
        frame_dir.mkdir(parents=True, exist_ok=True)
        from PIL import Image
        for i, f in enumerate(frames):
            Image.fromarray(f).save(frame_dir / f"frame_{i:04d}.png")
        return frame_dir
    return output_path


def collect_camera_poses(cameras: Cameras,
                         pose_adjustment: Optional[torch.Tensor] = None
                         ) -> list:
    """Per-frame camera-to-world transforms with the trained pose deltas
    applied."""
    c2w = cameras.c2w.detach().cpu().numpy()
    n = c2w.shape[0]
    if pose_adjustment is not None:
        adj = pose_adjustment.detach().cpu()[:n]
        R = exp_so3(adj[:, 3:]).numpy()
        adj = adj.numpy()
        c2w = c2w.copy()
        c2w[:, :, :3] = np.einsum("nij,njk->nik", R, c2w[:, :, :3])
        c2w[:, :, 3] = c2w[:, :, 3] + adj[:, :3]
    frames = []
    for i in range(n):
        mat = np.eye(4)
        mat[:3, :4] = c2w[i]
        frames.append({"file_path": f"frame_{i:05d}",
                       "transform": mat.tolist()})
    return frames


def export_camera_poses(run_dir: Path, cameras_train: Cameras,
                        cameras_eval: Cameras,
                        pose_adjustment: Optional[torch.Tensor] = None
                        ) -> Dict[str, Path]:
    """Write transforms_train.json / transforms_eval.json."""
    run_dir = Path(run_dir)
    out = {}
    for split, cams in (("train", cameras_train), ("eval", cameras_eval)):
        frames = collect_camera_poses(
            cams, pose_adjustment if split == "train" else None)
        p = run_dir / f"transforms_{split}.json"
        p.write_text(json.dumps({"frames": frames}, indent=2))
        out[split] = p
    return out
