"""K3 (``fused_mlp``) per head on one NVIDIA GPU: the vanilla field's
semantic and colour heads of a ``cropnerf-mxu`` preset (``--preset``:
``cropnerf-mxu``, the default, or ``-q``, ``-big``, ``-huge``, whose heads
are 64, 64, 128 and 128/256 wide) as the paths launch them.

For the port found under ``--port-root`` (default: this repository) this
script prints, as one JSON line, for each head:

- the forward at one export chunk (512 rays x 128 samples, N = 65,536),
  without a graph, as the volume export calls it once a head a chunk;
- the backward with dx alone at one BayesRays batch (4096 rays x the
  preset's samples a ray: 48, 128 for -big, 64 for -huge), as the
  uncertainty pass calls it (the semantics channel runs the semantic head
  alone, the rgb channel the colour head), and at the same batch the
  backward with dx and every weight gradient;

each as the device ms of the port's kernels (``torch.profiler``, the
median of three windows of 20 calls), the ms a call between CUDA events
(host time the card waits through included) and the bound (bytes: x, the
output or g and dx, and the weights, each once, over 3.35 TB/s; the
products over 989 TFLOP/s, whichever is larger).  It also prints the
rule-2 scores of the paths' launches, launches x (ms - bound ms): the
forward's 64 launches in the 128^3 export (each head once in each of 32
chunks) and the backward's 8 launches of the semantic head in 8 BayesRays
semantics batches.  The tree under ``--port-root`` picks each head's
kernels by its own route (``fused_mlp_route``), so two trees may time a
head on different kernels.  Run it on two trees
in turn in one call, alternating:

    python3 tools/mlp_head_times.py [--port-root DIR] [--preset NAME]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
EXPORT_N, EXPORT_CHUNKS = 512 * 128, 32
UNC_RAYS, UNC_BATCHES = 4096, 8


def device_ms(fn, iters: int = 20, windows: int = 3) -> float:
    """Device ms a call of the port's kernels (names in ``cropnerf::``),
    the median over profiler windows; CUDA events if none recorded any."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows + 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "cropnerf::" in e.key)
        if total > 0:
            per.append(total / 1e3 / iters)
        if len(per) == windows:
            break
    return statistics.median(per) if per else call_ms(fn, iters)


def call_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--preset", default="cropnerf-mxu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.vanilla import vanilla_field_init
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    dev = torch.device("cuda")
    model = PRESETS[args.preset].model
    unc_n = UNC_RAYS * model.num_nerf_samples_per_ray
    field = vanilla_field_init(model.field, 8,
                               torch.Generator().manual_seed(0), dev)
    g = torch.Generator(device=dev).manual_seed(31)
    heads = {}
    for label, mlp in (("semantic head", field.mlp_semantic),
                       ("colour head", field.mlp_color)):
        wbs = [t.detach() for w, b in zip(mlp.w, mlp.b)
               for t in (w, b.reshape(1, -1))]
        dims = [wbs[0].shape[0]] + [w.shape[1] for w in wbs[0::2]]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        w_bytes = sum(w.numel() * 4 for w in wbs)
        x = torch.randn((unc_n, dims[0]), generator=g, device=dev)
        cot = torch.randn((unc_n, dims[-1]), generator=g, device=dev)
        xf = x[:EXPORT_N]

        def fwd(xf=xf, wbs=wbs):
            with torch.no_grad():
                return kmlp.fused_mlp(xf, wbs)

        def bwd(x=x, cot=cot, wbs=wbs, need_dw=False):
            return kmlp.fused_mlp_bwd(x, wbs, cot, True, need_dw)

        def bwd_dw(x=x, cot=cot, wbs=wbs):
            return bwd(x, cot, wbs, True)

        hidden = macs - dims[-2] * dims[-1]
        heads[label] = {
            "dims": dims,
            "route": kmlp.fused_mlp_route(dims[0], dims[1:]),
            "fwd": {"n": EXPORT_N, "ms": device_ms(fwd),
                    "call_ms": call_ms(fwd),
                    "bound_ms": bound_ms(2.0 * EXPORT_N * macs,
                                         EXPORT_N * (dims[0] + dims[-1]) * 4
                                         + w_bytes)},
            "bwd_dx": {"n": unc_n, "ms": device_ms(bwd),
                       "call_ms": call_ms(bwd),
                       "bound_ms": bound_ms(2.0 * unc_n * (hidden + macs),
                                            unc_n * (2 * dims[0] + dims[-1])
                                            * 4 + w_bytes)},
            "bwd_dx_dw": {"n": unc_n, "ms": device_ms(bwd_dw),
                          "call_ms": call_ms(bwd_dw),
                          "bound_ms": bound_ms(
                              2.0 * unc_n * (hidden + 2 * macs),
                              unc_n * (2 * dims[0] + dims[-1]) * 4
                              + 2 * w_bytes)}}
    sem, col = heads["semantic head"], heads["colour head"]
    scores = {
        "fwd": EXPORT_CHUNKS * sum(h["fwd"]["ms"] - h["fwd"]["bound_ms"]
                                   for h in (sem, col)),
        "bwd": UNC_BATCHES * (sem["bwd_dx"]["ms"] - sem["bwd_dx"]["bound_ms"])}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"port_root": str(args.port_root), "card": smi,
                      "preset": args.preset,
                      "heads": heads, "rule2_scores": scores}), flush=True)


if __name__ == "__main__":
    main()
