"""K5 (``fused_pe_mlp``) per proposal net on one NVIDIA GPU, at a
``cropnerf-mxu`` preset's PE proposal nets (``--preset``: ``cropnerf-mxu``,
the default, 64 wide, or ``cropnerf-mxu-q``, 128 wide) and one training
step's rows (4096 rays x the net's samples a ray).

For the port found under ``--port-root`` (default: this repository) this
script prints, as one JSON line, for each net: the route the tree picks
(``pe_mlp_fwd_route``), the forward without a graph and, where the tree
has a backward kernel for the net, the backward with dx and every weight
gradient (a training step's) and with the weight gradients alone, each as
the device ms of the port's kernels (``torch.profiler``, the median of
three windows of 20 calls, 10 for the backward), the ms a call between
CUDA events, and the bound (the products over 989 TFLOP/s bf16, or x,
the output or g and dx, and the weights over 3.35 TB/s, whichever is
larger); and the card's name and power limit.  Run it on two trees in
turn in one call, alternating:

    python3 tools/pe_mlp_times.py [--port-root DIR] [--preset NAME]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from mlp_head_times import bound_ms, call_ms, device_ms  # noqa: E402


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
    from cropnerf_tpu_torch.models.proposal import proposal_init
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield
    dev = torch.device("cuda")
    cfg = PRESETS[args.preset]
    m, rays = cfg.model, cfg.train_num_rays_per_batch
    g = torch.Generator(device=dev).manual_seed(33)
    nets = {}
    for i, (p, smp) in enumerate(zip(m.proposal_fields,
                                     m.num_proposal_samples_per_ray)):
        prop = proposal_init(p, torch.Generator().manual_seed(i), dev)
        wbs = [t.detach() for w, b in zip(prop.mlp.w, prop.mlp.b)
               for t in (w, b.reshape(1, -1))]
        F, n = p.pe_freqs, rays * smp
        dims = [3 * (1 + 2 * F)] + [w.shape[1] for w in wbs[0::2]]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        hidden = macs - dims[-2] * dims[-1]
        w_bytes = sum(w.numel() * 4 for w in wbs)
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        cot = torch.randn((n, 1), generator=g, device=dev)

        def fwd(x=x, wbs=wbs, F=F):
            with torch.no_grad():
                return kfield.fused_pe_mlp(x, wbs, F)

        net = {"dims": dims, "n": n,
               "route": kfield.pe_mlp_fwd_route(3, F, dims[1:]),
               "fwd": {"ms": device_ms(fwd), "call_ms": call_ms(fwd),
                       "bound_ms": bound_ms(2.0 * n * macs,
                                            n * 16 + w_bytes)}}
        # a tree whose K5 has no backward for the net refuses it here
        refuse = getattr(kfield, "_check_pe_mlp_bwd", lambda *args: None)
        try:
            refuse(x, wbs, F)
        except ValueError:
            net["bwd"] = None
        else:
            for key, need_dx in (("bwd", True), ("bwd_dw_only", False)):
                def bwd(x=x, wbs=wbs, F=F, cot=cot, need_dx=need_dx):
                    return kfield.fused_pe_mlp_bwd(x, wbs, F, cot, need_dx)

                net[key] = {"ms": device_ms(bwd, 10),
                            "call_ms": call_ms(bwd, 10),
                            "bound_ms": bound_ms(
                                2.0 * n * (hidden + 2 * macs),
                                n * (28 if need_dx else 16)
                                + 2 * w_bytes)}
        nets[f"net {i}"] = net
        del x, cot
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"port_root": str(args.port_root), "card": smi,
                      "preset": args.preset, "nets": nets}), flush=True)


if __name__ == "__main__":
    main()
