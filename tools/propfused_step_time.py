"""Host and wall time of the fused-proposal ``cropnerf-mxu`` path (both PE
proposal nets on K5, ``mlp_impl="pallas-fused"``) on one NVIDIA GPU.

The path is host-bound: its training step's wall time moves with the load
on the host's cores while its device time holds.  For the port found
under ``--port-root`` (default: this repository) this script prints, as
one JSON line:

- for each proposal net at a training step's shape (4096 rays × 256 and
  × 96 samples), a K5 forward call without a graph (``fused_pe_mlp``
  under ``torch.no_grad``, as the render and the depth cloud call it) and
  a forward and backward with one (x and the weights requiring
  gradients, as the training step calls it): the host's ms a call to
  enqueue it, and the ms a call between CUDA events over back-to-back
  calls, host time the card waits through included;
- the training step at 4096 rays on a synthetic bank (as ``chip_smoke.py``
  builds it): each step's wall ms (synchronised before and after) and its
  host ms (until the step returns, unsynchronised), with their medians.

Run it on two trees in turn in one call, several times each, alternating,
so that both see the same load on the host:

    python3 tools/propfused_step_time.py [--port-root DIR] [--steps N]
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

from hash_bwd_real_step import synthetic_bank


def call_times(fn, iters: int) -> dict:
    """Host ms a call to enqueue ``fn`` and ms a call between CUDA events,
    over ``iters`` back-to-back calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return {"host_ms": host, "call_ms": start.elapsed_time(end) / iters}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--steps", type=int, default=60)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.proposal import proposal_init
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import make_train_step
    dev = torch.device("cuda")
    base = PRESETS["cropnerf-mxu"]
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, proposal_fields=tuple(
            dataclasses.replace(p, mlp_impl="pallas-fused")
            for p in base.model.proposal_fields)))
    m, rays = cfg.model, cfg.train_num_rays_per_batch
    g = torch.Generator(device=dev).manual_seed(13)
    nets = []
    for i, (p, smp) in enumerate(zip(m.proposal_fields,
                                     m.num_proposal_samples_per_ray)):
        prop = proposal_init(p, torch.Generator().manual_seed(i), dev)
        wbs = [t.detach() for w, b in zip(prop.mlp.w, prop.mlp.b)
               for t in (w, b.reshape(1, -1))]
        x = torch.rand((rays * smp, 3), generator=g, device=dev) * 2 - 1
        cot = torch.randn((rays * smp, 1), generator=g, device=dev)
        leaves = [x.requires_grad_(True)] + [w.requires_grad_(True)
                                             for w in wbs]

        def fwd(x=x, wbs=wbs, F=p.pe_freqs):
            with torch.no_grad():
                return kfield.fused_pe_mlp(x, wbs, F)

        def fwd_bwd(x=x, wbs=wbs, F=p.pe_freqs, cot=cot, leaves=leaves):
            return torch.autograd.grad(kfield.fused_pe_mlp(x, wbs, F),
                                       leaves, cot)

        nets.append({"n": rays * smp, "no_graph": call_times(fwd, 50),
                     "with_graph": call_times(fwd_bwd, 50)})

    bank = synthetic_bank(dev)
    state = create_train_state(cfg, bank.num_images,
                               torch.Generator().manual_seed(0), dev)
    step_fn = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    wall, host = [], []
    for _ in range(1 + args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, bank, gen)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "port_root": str(args.port_root), "card": smi, "k5": nets,
        "train": {"rays": rays, "steps": args.steps,
                  "wall_median_ms": statistics.median(wall[1:]),
                  "host_median_ms": statistics.median(host[1:]),
                  "wall_ms": wall, "host_ms": host}}), flush=True)


if __name__ == "__main__":
    main()
