"""Metrics sinks: JSONL event log + optional TensorBoard.

The port's own copy of ``cropnerf_tpu/utils/writer.py``: both packages
write the same ``logs/metrics.jsonl``.

Equivalent of the nerfstudio writer stack the reference configures with
``vis="viewer"`` (SURVEY §5.5; tensorboard/wandb via the same knob).  The
JSONL log is the always-on machine-readable sink; TensorBoard attaches when
the package is importable.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: Path, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "train") -> None:
        rec = {"step": step, "time": time.time(),
               **{f"{prefix}/{k}": float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float))}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
