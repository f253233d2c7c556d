"""Minimal PLY point-cloud IO (binary little-endian), numpy only.

The port's own copy of ``cropnerf_tpu/export/ply.py``: both packages write
the same artifact format, which the counting stage reads.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def write_ply(path: Path, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              alpha: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """points [N,3] float; colors [N,3] uint8 or float in [0,1]; alpha [N];
    normals [N,3] float (nx/ny/nz, the Open3D depth-export convention)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
    cols = None
    if colors is not None:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        if alpha is not None:
            a = np.asarray(alpha)
            if a.dtype != np.uint8:
                a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
            cols = np.concatenate([cols, a[:, None]], axis=1)
            props.append("property uchar alpha")
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}", *props, "end_header", ""])
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if cols is not None:
        names = ["red", "green", "blue", "alpha"][:cols.shape[1]]
        fields += [(nm, "u1") for nm in names]
    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        nrm = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if cols is not None:
        for i, nm in enumerate(["red", "green", "blue", "alpha"][:cols.shape[1]]):
            rec[nm] = cols[:, i]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def ply_vertex_count(path: Path) -> int:
    """Vertex count from the header only (no payload read — exported
    clouds run to 10M+ points)."""
    with open(path, "rb") as f:
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                return int(line.split()[2])
            if line == "end_header" or not line:
                raise ValueError(f"no vertex element in {path}")


def read_ply(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read ascii or binary_little_endian PLY → (points [N,3] f32,
    colors [N,3] u8 or None).  Supports float/double xyz + uchar rgb(a)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header_lines if l.startswith("format"))
        n = int(next(l.split()[2] for l in header_lines
                     if l.startswith("element vertex")))
        props = []
        in_vertex = False
        for l in header_lines:
            if l.startswith("element"):
                in_vertex = l.startswith("element vertex")
            elif l.startswith("property") and in_vertex:
                _, typ, name = l.split()
                props.append((name, typ))
        typemap = {"float": "<f4", "float32": "<f4", "double": "<f8",
                   "uchar": "u1", "uint8": "u1", "int": "<i4",
                   "uint": "<u4", "ushort": "<u2", "short": "<i2"}
        if fmt == "binary_little_endian":
            dtype = np.dtype([(nm, typemap[t]) for nm, t in props])
            rec = np.fromfile(f, dtype=dtype, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            if data.ndim == 1:
                data = data[None]
            rec = {nm: data[:, i] for i, (nm, _) in enumerate(props)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    pts = np.stack([np.asarray(rec["x"], np.float32),
                    np.asarray(rec["y"], np.float32),
                    np.asarray(rec["z"], np.float32)], axis=1)
    names = [nm for nm, _ in props]
    colors = None
    if {"red", "green", "blue"} <= set(names):
        colors = np.stack([np.asarray(rec["red"]),
                           np.asarray(rec["green"]),
                           np.asarray(rec["blue"])], axis=1).astype(np.uint8)
    return pts, colors
