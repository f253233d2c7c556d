"""ctypes binding for the native point-cloud ops (counterpart of
``cropnerf_tpu/native/pointcloud_ops.py``; its wrappers hold the JAX
file's code, see tests/test_torch_copies.py).

The library is built at first use from ``src/pointcloud_ops.cc`` by the
``Makefile`` beside it into ``cropnerf_tpu_torch/_build`` (listed in
``.gitignore``); nothing is built into the source tree.  Its file name
carries a hash of the source, the Makefile and the host CPU's model and
flags, since ``-march=native`` code runs only on the CPU it was built for.
When the build or the load fails, :func:`available` is False and
:func:`load_error` returns the compiler's output, so a caller can say why
before :mod:`cropnerf_tpu_torch.counting.clustering` falls through to its
numpy/sklearn paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).parent
BUILD_DIR = _DIR.parent / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _cpu_identity() -> bytes:
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [line for line in lines
            if line.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(_cpu_identity())
    for p in (_DIR / "Makefile", _DIR / "src" / "pointcloud_ops.cc"):
        h.update(p.read_bytes())
    return Path(build_dir) / f"libpointcloud_ops-{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library into ``build_dir`` unless it is there already;
    raises RuntimeError with make's output when the build fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["make", "-s", "-C", str(_DIR),
                               f"LIB={tmp}"], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build could not run make: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed (make exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its functions' signatures."""
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [f32p, ctypes.c_int, ctypes.c_float, f32p]
    lib.dbscan.restype = ctypes.c_int
    lib.dbscan.argtypes = [f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           i32p]
    lib.statistical_outlier_removal.restype = None
    lib.statistical_outlier_removal.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, u8p]
    lib.kmeans.restype = None
    lib.kmeans.argtypes = [f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_uint32, i32p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _lib = open_library(build())
    except (RuntimeError, OSError) as e:
        _error = str(e)
    return _lib


def load_error() -> Optional[str]:
    """Why the library is not available (the build's output), or None."""
    _load()
    return _error


def available() -> bool:
    return _load() is not None


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty_like(pts)
    m = lib.voxel_downsample(pts, len(pts), voxel_size, out)
    return out[:m].copy()


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    labels = np.empty(len(pts), np.int32)
    lib.dbscan(pts, len(pts), eps, min_points, labels)
    return labels.astype(np.int64)


def statistical_outlier_removal(points: np.ndarray, nb_neighbors: int = 20,
                                std_ratio: float = 2.0) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    keep = np.empty(len(pts), np.uint8)
    lib.statistical_outlier_removal(pts, len(pts), nb_neighbors, std_ratio,
                                    keep)
    return np.where(keep > 0)[0]


def kmeans(points: np.ndarray, k: int, seed: int = 0,
           iters: int = 50) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    labels = np.zeros(len(pts), np.int32)
    lib.kmeans(pts, len(pts), k, iters, seed, labels)
    return labels.astype(np.int64)
