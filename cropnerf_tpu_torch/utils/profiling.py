"""Profiling and step-timing instrumentation (counterpart of
``cropnerf_tpu/utils/profiling.py``): a ``torch.profiler`` trace of the
host and the card, and a host-side step timer with rays/s and an EMA step
time.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def device_trace(logdir: Path):
    """Trace the block with ``torch.profiler`` (host, and the card when one
    is visible) and write a Chrome trace, ``trace.json``, under ``logdir``
    (open it in Perfetto or chrome://tracing).  Yields the profiler, whose
    ``key_averages()`` sums the time by operator."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class StepTimer:
    """Rays/s + EMA step-time counters (≙ the reference's
    num_rays_per_sec/fps metrics, fruit_pipeline.py:216-220)."""

    def __init__(self, rays_per_step: int, ema: float = 0.9):
        self.rays_per_step = rays_per_step
        self.ema = ema
        self._last: Optional[float] = None
        self.step_time_ema: Optional[float] = None
        self.total_steps = 0
        self.total_time = 0.0

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        out: Dict[str, float] = {}
        if self._last is not None:
            dt = now - self._last
            self.total_time += dt
            self.total_steps += 1
            self.step_time_ema = (dt if self.step_time_ema is None else
                                  self.ema * self.step_time_ema
                                  + (1 - self.ema) * dt)
            out = {
                "step_time_ms": self.step_time_ema * 1e3,
                "rays_per_s": self.rays_per_step / max(self.step_time_ema,
                                                       1e-9),
            }
        self._last = now
        return out

    @property
    def mean_rays_per_s(self) -> float:
        if self.total_time == 0:
            return 0.0
        return self.total_steps * self.rays_per_step / self.total_time
