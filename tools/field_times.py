"""Device times of the PE field's kernels (K1 ``fused_pe_nerf`` and K2
``fused_pe_density``, forward and backward) and of K5's stream route, on
one NVIDIA GPU, for comparing two trees of the port in one call (run it
on each, alternating: parent, change, change, parent).  Seeded random
weights; cropnerf-mxu's field (256 wide) at a training step's rows (4096
rays x 48 samples), K2 forward at a 128-side export chunk, its dx-only
backward at a BayesRays batch, K5 at [prop256]'s two nets (3 layers 256
wide), K3's stream route at -huge's 256-wide semantic head (dx alone at
its BayesRays batch, and with dW; its forward at an export chunk); then
the same at [w512]'s widths (field trunk and semantic head 512 wide, K5
nets 3 x 512, K3's semantic head [15, 512, 1]), and K1's and K2's at
[w1024]'s (a 1024-wide trunk, 64-wide heads), where the tree takes them
("no kernel" otherwise).  Each time is the median of five CUDA-event
windows of ten calls, after two warm-up calls.  ``--only TEXT[,TEXT...]``
times only the calls whose names hold one of the comma-separated TEXTs:

    python3 tools/field_times.py [--port-root DIR] [--only TEXT[,TEXT...]]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

import torch


def cuda_ms(fn, iters: int = 10, windows: int = 5) -> float:
    for _ in range(2):
        fn()
    runs = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    parser.add_argument("--only", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import model_init
    from cropnerf_tpu_torch.models.vanilla import (POS_FREQS,
                                                   fused_field_weights)
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    dev = torch.device("cuda")
    out = {}
    for width in (256, 512, 1024):
        g = torch.Generator(device=dev).manual_seed(41)
        m = PRESETS["cropnerf-mxu"].model
        m = dataclasses.replace(m, field=dataclasses.replace(
            m.field, hidden_dim=width,
            hidden_dim_semantics=width if width == 512 else 64))
        params = model_init(m, 8, torch.Generator().manual_seed(0), dev)
        base, top, color, sem = ([w.detach() for w in ws] for ws in
                                 fused_field_weights(params.field, m.field))
        n = 4096 * m.num_nerf_samples_per_ray
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        ex = torch.randn((n, color[1].shape[0]), generator=g, device=dev)
        cots = [torch.randn((n, c), generator=g, device=dev)
                for c in (top[-2].shape[1], 3, sem[-2].shape[1])]
        x2 = x[:512 * 128].contiguous()
        calls = {
            "fused_pe_nerf": lambda: kf.fused_pe_nerf(
                x, ex, base, top, color, sem, POS_FREQS),
            "fused_pe_nerf_bwd": lambda: kf.fused_pe_nerf_bwd(
                x, ex, base, top, color, sem, POS_FREQS, *cots),
            "fused_pe_density": lambda: kf.fused_pe_density(
                x2, base, top, POS_FREQS),
            "fused_pe_density_bwd dx": lambda: kf.fused_pe_density_bwd(
                x, base, top, POS_FREQS, cots[0], True, False)}
        for i, (F, smp) in enumerate(((5, 256), (6, 96))
                                     if width < 1024 else ()):
            din = 3 * (1 + 2 * F)
            wbs = []
            for a, b in zip((din, width, width), (width, width, 1)):
                wbs += [torch.randn((a, b), generator=g, device=dev)
                        / a ** 0.5,
                        torch.randn((1, b), generator=g, device=dev) * 0.05]
            xp = torch.rand((4096 * smp, 3), generator=g, device=dev) * 2 - 1
            cp = torch.randn((4096 * smp, 1), generator=g, device=dev)
            calls[f"fused_pe_mlp net {i}"] = (
                lambda xp=xp, wbs=wbs, F=F: kf.fused_pe_mlp(xp, wbs, F))
            calls[f"fused_pe_mlp_bwd net {i}"] = (
                lambda xp=xp, wbs=wbs, F=F, cp=cp: kf.fused_pe_mlp_bwd(
                    xp, wbs, F, cp))
        # K3's stream route: the semantic head, at its BayesRays batch
        # (none at 1024: [w1024]'s heads are 64 wide)
        dims, n3 = (((30, 256, 256, 1), 262_144) if width == 256
                    else ((15, 512, 1), 196_608))
        w3 = []
        for a, b in zip(dims[:-1], dims[1:]):
            w3 += [torch.randn((a, b), generator=g, device=dev) / a ** 0.5,
                   torch.randn((1, b), generator=g, device=dev) * 0.05]
        x3 = torch.randn((n3, dims[0]), generator=g, device=dev)
        c3 = torch.randn((n3, 1), generator=g, device=dev)
        x3e = x3[:512 * 64].contiguous()
        if width < 1024:
            calls["fused_mlp semantic head"] = lambda: km.fused_mlp(x3e, w3)
            calls["fused_mlp_bwd semantic head dx"] = (
                lambda: km.fused_mlp_bwd(x3, w3, c3, True, False))
            calls["fused_mlp_bwd semantic head with dW"] = (
                lambda: km.fused_mlp_bwd(x3, w3, c3, True, True))
        with torch.no_grad():
            for name, fn in calls.items():
                if not any(t in f"{name} {width}"
                           for t in args.only.split(",")):
                    continue
                try:
                    out[f"{name} {width}"] = cuda_ms(fn)
                except ValueError:
                    out[f"{name} {width}"] = "no kernel"
        del params, x, ex, cots, calls, x3, c3, x3e
        torch.cuda.empty_cache()
    print(json.dumps({"port_root": str(args.port_root),
                      "card": torch.cuda.get_device_name(0), "ms": out}),
          flush=True)


if __name__ == "__main__":
    main()
