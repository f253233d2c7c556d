"""PyTorch / CUDA port of cropnerf_tpu for NVIDIA Hopper GPUs.

Imports torch, numpy and the standard library only; never JAX or the
``cropnerf_tpu`` package, whose framework-neutral pieces it keeps its own
copies of.  Entry points place work on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from .models.config import PRESETS  # noqa: F401
