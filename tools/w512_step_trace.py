"""Device time of one ``[w512]`` training step on one NVIDIA GPU, for
comparing two trees of the port in one call (run it on each, alternating:
parent, change, change, parent).

``[w512]`` is cropnerf-mxu with its field's trunk and semantic head 512
wide and both PE proposal nets on the fused kernel (K5), 3 layers 512
wide, as ``chip_smoke.py``'s ``[w512]`` phase builds it: K1 forward and
backward and K5's stream route forward and backward run in every step.
The step trains on the synthetic 32-image bank ``chip_smoke.py`` trains on
(``tools/hash_bwd_real_step.py`` ``synthetic_bank``), 4096 rays, seeded
weights.  After ``--warmup`` steps, ``--traces`` steps each run under
``torch.profiler``: the device's busy ms (the device time of every kernel
and copy) and the step's wall ms (synchronised).  One JSON line: their
medians, each traced step's values, and the largest device items of the
last trace (ms, count):

    python3 tools/w512_step_trace.py [--port-root DIR] [--warmup N] [--traces N]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hash_bwd_real_step import synthetic_bank

WIDTH = 512


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--traces", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import make_train_step
    dev = torch.device("cuda")
    base = PRESETS["cropnerf-mxu"]
    m = base.model
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, hidden_dim=WIDTH,
                                     hidden_dim_semantics=WIDTH),
        proposal_fields=tuple(dataclasses.replace(
            p, mlp_impl="pallas-fused", hidden_dim=WIDTH)
            for p in m.proposal_fields)))
    bank = synthetic_bank(dev)
    state = create_train_state(cfg, bank.num_images,
                               torch.Generator().manual_seed(0), dev)
    step_fn = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    for _ in range(args.warmup):
        step_fn(state, bank, gen)
    torch.cuda.synchronize()
    busy, wall, top = [], [], []
    for _ in range(args.traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, bank, gen)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        # device-side rows only (kernels, copies): the host operators that
        # launched them report the same time again
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy.append(sum(r[1] for r in rows))
        top = [(k[:90], round(ms, 4), n) for k, ms, n in rows[:10]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"port_root": str(args.port_root), "card": smi,
                      "device_busy_median_ms": statistics.median(busy),
                      "wall_median_ms": statistics.median(wall),
                      "device_busy_ms": busy, "wall_ms": wall, "top": top}),
          flush=True)


if __name__ == "__main__":
    main()
