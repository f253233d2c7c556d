"""Builds the CUDA sources in ``cropnerf_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface, loaded with ``ctypes``.  A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt; libraries and ``-Xptxas -v`` reports go to
``cropnerf_tpu_torch/_build`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("fused_pe_field", "fused_pe_field_bwd", "fused_mlp_stream",
           "fused_mlp_fwd", "fused_mlp_bwd", "fused_pe_mlp_fwd",
           "fused_pe_mlp_bwd", "fused_pe_mlp_wide_bwd", "hash_encode",
           "transmittance")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is missing, with one nvcc
    process per source, all started together.  Returns each library's
    compiler report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(exist_ok=True)
    names = list(names)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built first if needed."""
    lib = library_path(name)
    if not lib.exists():
        build((name,))
    return ctypes.CDLL(str(lib))
