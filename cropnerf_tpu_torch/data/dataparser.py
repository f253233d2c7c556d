"""transforms.json dataparser: poses, intrinsics, splits, scene box.

The port's own copy of ``cropnerf_tpu/data/dataparser.py`` (numpy and
json only), so that both packages parse a dataset into the same cameras,
splits and ``dataparser_transforms.json``.

Equivalent of ``CottonNerfDataParser`` / ``FruitNerfDataParser``
(the reference's crop_nerf/fruit_nerf/data/cotton_nerf_dataparser.py:76-290,
fruitnerf_dataparser.py:73-293): parse per-frame intrinsics/distortion/poses,
derive semantic mask paths, split train/eval, auto-orient ("up") + center +
scale poses into the ±1 box, and emit stacked camera arrays.

Host-side numpy (runs once at startup); the output feeds the on-device
pixel bank.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

MAX_AUTO_RESOLUTION = 1200   # fruitnerf_dataparser.py:39


@dataclasses.dataclass
class DataparserConfig:
    data_dir: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None       # None → auto (<1200 px)
    scene_scale: float = 1.0                      # aabb half-extent
    orientation_method: str = "up"                # "up" | "none"
    center_method: str = "poses"                  # "poses" | "none"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.95            # cotton default (:52)
    semantic_dir: str = "semantics"               # cotton default (:58)
    semantic_ext: str = ".png"


@dataclasses.dataclass
class DataparserOutputs:
    """Stacked numpy camera/pose data + file lists for one split."""
    image_paths: List[Path]
    semantic_paths: List[Path]
    c2w: np.ndarray            # [N, 3, 4] after orient/center/scale
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray
    height: np.ndarray
    distortion: np.ndarray     # [N, 6] (k1..k4, p1, p2)
    scene_box: np.ndarray      # [2, 3]
    dataparser_transform: np.ndarray   # [3, 4] applied world transform
    dataparser_scale: float
    downscale_factor: int


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b
    (nerfstudio ``camera_utils.rotation_matrix_between``)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "poses"
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate so the mean camera up-vector is +Z and translate the pose
    centroid to the origin (nerfstudio ``auto_orient_and_center_poses``,
    bound at cotton_nerf_dataparser.py:192-196).

    poses: [N, 4, 4] (or [N, 3, 4]).  Returns (oriented [N, 3, 4],
    transform [3, 4]).
    """
    origins = poses[:, :3, 3]
    center = origins.mean(axis=0) if center_method == "poses" else np.zeros(3)
    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        R = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    else:
        R = np.eye(3)
    transform = np.concatenate([R, (-R @ center)[:, None]], axis=1)  # [3,4]
    oriented = np.einsum("ij,njk->nik",
                         np.concatenate([transform, [[0, 0, 0, 1]]], 0),
                         poses if poses.shape[1] == 4 else
                         np.concatenate([poses, np.tile([[[0, 0, 0, 1]]], (len(poses), 1, 1))], 1))
    return oriented[:, :3, :], transform


def _split_indices(n: int, fraction: float) -> Tuple[np.ndarray, np.ndarray]:
    """Equally-spaced train/eval split (cotton_nerf_dataparser.py:166-183)."""
    num_train = int(np.ceil(n * fraction))
    num_eval = n - num_train
    i_all = np.arange(n)
    i_train = np.linspace(0, n - 1, num_train, dtype=int)
    i_train = np.unique(i_train)
    i_eval = np.setdiff1d(i_all, i_train)
    if len(i_eval) == 0:        # tiny datasets: reuse a train view for eval
        i_eval = i_all[-1:]
    return i_train, i_eval


def parse_transforms(config: DataparserConfig, split: str = "train"
                     ) -> DataparserOutputs:
    data_dir = Path(config.data_dir)
    meta = json.loads((data_dir / "transforms.json").read_text())

    frames = meta["frames"]
    # Sort by file name for deterministic splits (reference sorts fnames).
    frames = sorted(frames, key=lambda f: f["file_path"])

    poses, fx, fy, cx, cy, ws, hs, dist = [], [], [], [], [], [], [], []
    image_paths, semantic_paths = [], []

    def get(frame, key, default=0.0):
        return frame.get(key, meta.get(key, default))

    for frame in frames:
        fpath = data_dir / frame["file_path"]
        image_paths.append(fpath)
        if "semantic_path" in frame:
            semantic_paths.append(data_dir / frame["semantic_path"])
        else:
            # cotton parser: semantics/<image_name>.<ext> (:144-145,292-297)
            semantic_paths.append(
                data_dir / config.semantic_dir /
                (fpath.stem + config.semantic_ext))
        poses.append(np.array(frame["transform_matrix"], np.float64))
        fx.append(get(frame, "fl_x"))
        fy.append(get(frame, "fl_y"))
        cx.append(get(frame, "cx"))
        cy.append(get(frame, "cy"))
        ws.append(int(get(frame, "w")))
        hs.append(int(get(frame, "h")))
        dist.append([get(frame, "k1"), get(frame, "k2"), get(frame, "k3"),
                     get(frame, "k4"), get(frame, "p1"), get(frame, "p2")])

    poses = np.stack(poses)
    n = len(frames)

    # split selection: explicit *_filenames keys or equally-spaced
    if f"{split}_filenames" in meta or "train_filenames" in meta:
        names = {Path(p).name for p in meta.get(f"{split}_filenames", [])}
        idx = np.array([i for i, p in enumerate(image_paths)
                        if p.name in names], dtype=int)
        if len(idx) == 0:
            i_train, i_eval = _split_indices(n, config.train_split_fraction)
            idx = i_train if split == "train" else i_eval
    else:
        i_train, i_eval = _split_indices(n, config.train_split_fraction)
        idx = i_train if split == "train" else i_eval

    oriented, transform = auto_orient_and_center_poses(
        poses, config.orientation_method, config.center_method)

    scale = 1.0
    if config.auto_scale_poses:
        scale = 1.0 / max(float(np.max(np.abs(oriented[:, :3, 3]))), 1e-8)
    scale *= config.scale_factor
    oriented[:, :3, 3] *= scale

    # downscale factor: halve until <= MAX_AUTO_RESOLUTION (:299-331)
    ds = config.downscale_factor
    if ds is None:
        ds = 1
        m = max(max(ws), max(hs))
        while m // (2 * ds) > MAX_AUTO_RESOLUTION:
            ds *= 2

    s = config.scene_scale
    scene_box = np.array([[-s, -s, -s], [s, s, s]], np.float32)

    sel = idx
    return DataparserOutputs(
        image_paths=[image_paths[i] for i in sel],
        semantic_paths=[semantic_paths[i] for i in sel],
        c2w=oriented[sel].astype(np.float32),
        fx=(np.array(fx)[sel] / ds).astype(np.float32),
        fy=(np.array(fy)[sel] / ds).astype(np.float32),
        cx=(np.array(cx)[sel] / ds).astype(np.float32),
        cy=(np.array(cy)[sel] / ds).astype(np.float32),
        width=(np.array(ws)[sel] // ds).astype(np.int32),
        height=(np.array(hs)[sel] // ds).astype(np.int32),
        distortion=np.array(dist, np.float32)[sel],
        scene_box=scene_box,
        dataparser_transform=transform.astype(np.float32),
        dataparser_scale=float(scale),
        downscale_factor=int(ds),
    )
