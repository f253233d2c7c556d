"""Volume-rendering weights from a transmittance scan (counterpart of
``cropnerf_tpu/ops/pallas/transmittance.py``).

``render_weights_cuda`` launches the CUDA kernel ``csrc/transmittance.cu``
(replacing the Pallas ``_kernel``) for tensors on the card and computes
``ops/render.py`` ``render_weights``, its plain version, for tensors on the
CPU.  It takes any [R, S] (no tile constraint, no fallback) and is forward
only, as the Pallas kernel is: it refuses inputs that record an autograd
graph, so that no gradient passes through it silently.  No model path calls
it, as no model path of the JAX package calls the Pallas kernel; the
compositors use ``render_weights``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..render import render_weights
from . import build
from .common import stream_ptr


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("transmittance")
    lib.cropnerf_render_weights.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.cropnerf_render_weights.restype = ctypes.c_int
    return lib


def render_weights_cuda(density: torch.Tensor,
                        deltas: torch.Tensor) -> torch.Tensor:
    """weights = (1 - e^{-σδ}) · e^{-(cumsum σδ - σδ)} along the sample axis;
    density, deltas [R, S] (cast to float32) → weights [R, S] float32."""
    if density.dim() != 2 or density.shape != deltas.shape:
        raise ValueError(f"density and deltas must be [R, S] of one shape, "
                         f"got {tuple(density.shape)} and "
                         f"{tuple(deltas.shape)}")
    if torch.is_grad_enabled() and (density.requires_grad
                                    or deltas.requires_grad):
        raise ValueError("render_weights_cuda is forward only (as the Pallas "
                         "kernel): use ops.render.render_weights where a "
                         "gradient is needed")
    density = density.float().contiguous()
    deltas = deltas.float().contiguous()
    if density.device.type == "cpu" and deltas.device.type == "cpu":
        return render_weights(density, deltas)
    device = density.device
    if device.type != "cuda" or deltas.device != device:
        raise ValueError(f"render_weights_cuda: expected CPU or CUDA tensors "
                         f"on one device, got {device} and {deltas.device}")
    n_rays, n_samples = density.shape
    out = torch.empty_like(density)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().cropnerf_render_weights(
            density.data_ptr(), deltas.data_ptr(), out.data_ptr(), n_rays,
            n_samples, stream_ptr(device))
    if err:
        raise RuntimeError(f"render_weights kernel launch failed: "
                           f"cudaError {err}")
    render_weights_cuda.launches += 1
    return out


render_weights_cuda.launches = 0
