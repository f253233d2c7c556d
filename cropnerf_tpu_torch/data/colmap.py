"""COLMAP model → ``transforms.json`` converter (pure Python).

The port's own copy of ``cropnerf_tpu/data/colmap.py``: its code is
held equal by tests/test_torch_copies.py, so that both packages read
and write the same artifacts.

Structural equivalent of the reference's dataset-builder COLMAP step
(the reference's crop_nerf/fruit_nerf/fruit_nerf_dataset.py:342-378:
``ColmapConverterToNerfstudioDataset`` + ``_save_transforms`` with the
``semantics`` classes and per-frame ``semantic_path`` injected).  Running
COLMAP itself stays out of scope (external binary, SURVEY §2.3 N8) — this
module consumes a finished sparse reconstruction (text or binary model) and
emits the 3DCotton ``transforms.json`` layout that
:mod:`cropnerf_tpu_torch.data.dataparser` parses.

Pose convention: COLMAP stores world→camera [R|t] in OpenCV axes; frames are
written as camera→world in OpenGL axes with the nerfstudio world rotation
(x↔y swap, z flip) so downstream orientation/centering behaves identically
to the reference pipeline.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

# COLMAP camera models: id → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    qvec: np.ndarray          # [4] w, x, y, z
    tvec: np.ndarray          # [3]
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`qvec_to_rotmat` (used by tests / writers)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# -- text model --------------------------------------------------------------

def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            model=parts[1], width=int(parts[2]), height=int(parts[3]),
            params=np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    # two lines per image: pose line, then a 2D-points line that may be
    # EMPTY — keep blank lines so the pairing stays aligned
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if not ln.strip().startswith("#")]
    while lines and not lines[0]:
        lines.pop(0)
    while lines and not lines[-1]:
        lines.pop()
    for pose_line in lines[0::2]:
        parts = pose_line.split()
        images[int(parts[0])] = ColmapImage(
            qvec=np.array([float(p) for p in parts[1:5]]),
            tvec=np.array([float(p) for p in parts[5:8]]),
            camera_id=int(parts[8]), name=parts[9])
    return images


# -- binary model ------------------------------------------------------------

def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(model=name, width=int(w),
                                        height=int(h), params=params)
    return cams


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(n_pts * 24, 1)          # skip 2D points (2 double + int64)
            images[image_id] = ColmapImage(
                qvec=np.array([qw, qx, qy, qz]),
                tvec=np.array([tx, ty, tz]),
                camera_id=cam_id, name=name.decode())
    return images


def read_model(colmap_dir: Path):
    """Load cameras+images from a COLMAP sparse dir (text or binary)."""
    colmap_dir = Path(colmap_dir)
    if (colmap_dir / "cameras.txt").exists():
        return (read_cameras_text(colmap_dir / "cameras.txt"),
                read_images_text(colmap_dir / "images.txt"))
    if (colmap_dir / "cameras.bin").exists():
        return (read_cameras_binary(colmap_dir / "cameras.bin"),
                read_images_binary(colmap_dir / "images.bin"))
    raise FileNotFoundError(f"no cameras.txt/.bin under {colmap_dir}")


# -- conversion ---------------------------------------------------------------

def _intrinsics_dict(cam: ColmapCamera) -> dict:
    p = cam.params
    out = {"w": cam.width, "h": cam.height}
    if cam.model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif cam.model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif cam.model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif cam.model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif cam.model == "OPENCV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], p1=p[6], p2=p[7])
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model} "
                         "(fisheye models are not part of the pinhole "
                         "pipeline)")
    return {k: (float(v) if not isinstance(v, int) else v)
            for k, v in out.items()}


# nerfstudio's colmap→world rotation: swap x/y, flip z (colmap_to_json)
APPLIED_TRANSFORM = np.array([
    [0.0, 1.0, 0.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
])


def colmap_pose_to_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP world→camera (OpenCV) → camera→world 4x4 (OpenGL axes,
    nerfstudio world rotation applied)."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec_to_rotmat(qvec)
    w2c[:3, 3] = tvec
    c2w = np.linalg.inv(w2c)
    c2w[0:3, 1:3] *= -1          # OpenCV → OpenGL camera axes
    c2w = c2w[np.array([1, 0, 2, 3]), :]
    c2w[2, :] *= -1              # nerfstudio world rotation
    return c2w


def colmap_to_transforms(colmap_dir: Path, output_path: Path,
                         images_rel_dir: str = "images",
                         semantic_rel_dir: Optional[str] = None,
                         semantic_classes: Optional[List[str]] = None,
                         semantic_ext: Optional[str] = None) -> dict:
    """Convert a COLMAP sparse model into the 3DCotton transforms.json.

    ``semantic_rel_dir`` injects per-frame ``semantic_path`` entries and a
    ``semantics`` class list exactly like the reference's dataset builder
    (fruit_nerf_dataset.py:364-373).  Returns the written dict.
    """
    cameras, images = read_model(colmap_dir)
    frames = []
    for img in sorted(images.values(), key=lambda im: im.name):
        cam = cameras[img.camera_id]
        frame = dict(_intrinsics_dict(cam))
        frame["file_path"] = f"{images_rel_dir}/{img.name}"
        frame["transform_matrix"] = colmap_pose_to_c2w(
            img.qvec, img.tvec).tolist()
        if semantic_rel_dir is not None:
            name = img.name
            if semantic_ext is not None:
                name = str(Path(name).with_suffix(semantic_ext))
            frame["semantic_path"] = f"{semantic_rel_dir}/{name}"
        frames.append(frame)
    meta = {
        "camera_model": "OPENCV",
        "applied_transform": APPLIED_TRANSFORM.tolist(),
        "frames": frames,
    }
    if semantic_rel_dir is not None:
        meta["semantics"] = semantic_classes or ["stuff", "crop"]
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(meta, indent=4))
    return meta
