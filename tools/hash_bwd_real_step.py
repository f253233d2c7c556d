"""The hash-grid encode (K4, ``hash_encode_fwd`` and ``hash_encode_bwd``)
on the inputs of one real ``cropnerf`` training step, on one NVIDIA GPU.

A training step's samples bunch along rays and into the scene, so its
positions collide in the coarse cells far more than uniform ones do and
share more table sectors.  ``step_inputs`` runs one step (``train_loss``
and its backward, random weights from seed 0, 4096 rays from a bank of
synthetic images) and keeps the (table, positions, layout) of the step's
three forward calls and the (table, positions, cotangent, layout) of its
three backward calls: the field and the two proposal nets.
``chip_smoke.py`` checks and times the kernels on them beside uniform
positions.  Run alone, this script prints the device time of the three
forward calls and of the three backward calls, each summed, for the port
found under ``--port-root`` (default: this repository), so that two trees
can be timed in one call on the same card:

    python3 tools/hash_bwd_real_step.py [--port-root DIR]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BANK = (32, 800, 1200)   # images, height, width (bench.py's training shapes)


def synthetic_bank(dev):
    """The pixel bank chip_smoke.py trains on: random images and masks,
    seeded, resident on the card."""
    from cropnerf_tpu_torch.core.cameras import Cameras
    from cropnerf_tpu_torch.data.databank import build_pixel_bank
    n_img, bh, bw = BANK
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (n_img, bh, bw, 3), dtype=np.uint8)
    masks = (rs.rand(n_img, bh, bw) > 0.9).astype(np.uint8)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n_img, 1, 1))
    c2w[:, :, 3] = rs.randn(n_img, 3) * 0.5
    full = lambda v: torch.full((n_img,), v, device=dev)  # noqa: E731
    return build_pixel_bank(images, masks, Cameras(
        c2w=torch.from_numpy(c2w).to(dev), fx=full(1000.0), fy=full(1000.0),
        cx=full(bw / 2.0), cy=full(bh / 2.0), width=full(bw).long(),
        height=full(bh).long()), device=dev)


def step_inputs(bank, dev) -> dict:
    """{"fwd": [(table2d, positions, layout)], "bwd": [(table2d,
    positions, cotangent, layout)]} of the hash_encode_fwd and
    hash_encode_bwd calls of one cropnerf training step on ``bank``,
    copied as the kernels received them."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import train_loss
    cfg = PRESETS["cropnerf"]
    state = create_train_state(cfg, bank.num_images,
                               torch.Generator().manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, bank.num_pixels, (cfg.train_num_rays_per_batch,),
                        generator=gen, device=dev)
    captured = {"fwd": [], "bwd": []}
    fwd, bwd = kh.hash_encode_fwd, kh.hash_encode_bwd

    def capture_fwd(table2d, pos, *layout):
        captured["fwd"].append((table2d.detach().clone(), pos.clone(),
                                layout))
        return fwd(table2d, pos, *layout)

    def capture_bwd(table2d, pos, grad, *layout, **kw):
        captured["bwd"].append((table2d.detach().clone(), pos.clone(),
                                grad.clone(), layout))
        # the kernel counts its launches on the module's hash_encode_bwd
        kh.hash_encode_bwd = bwd
        try:
            return bwd(table2d, pos, grad, *layout, **kw)
        finally:
            kh.hash_encode_bwd = capture_bwd

    kh.hash_encode_fwd, kh.hash_encode_bwd = capture_fwd, capture_bwd
    try:
        loss, _ = train_loss(state.params, bank, idx, 0, cfg, gen)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        kh.hash_encode_fwd, kh.hash_encode_bwd = fwd, bwd
    return captured


def device_ms(fn, iters: int = 10, windows: int = 5) -> float:
    """Device time per call of the port's kernels (profiler rows in the
    cropnerf:: namespace) over ``iters`` calls after two warm-up calls.
    The profiler now and then drops a window's rows, so a window with none
    is profiled again, up to ``windows`` windows in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "cropnerf::" in e.key)
        if total > 0:
            return total / 1e3 / iters
    raise SystemExit("the profiler saw no device time of the kernels")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--port-root", type=Path,
                        default=Path(__file__).resolve().parents[1])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    sys.path.insert(0, str(args.port_root.resolve()))
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    dev = torch.device("cuda")
    captured = step_inputs(synthetic_bank(dev), dev)
    out = {}
    for name, calls in captured.items():
        per_call = []
        for table2d, pos, *grad, layout in calls:
            def fn(table2d=table2d, pos=pos, grad=grad, layout=layout):
                if grad:
                    return kh.hash_encode_bwd(table2d, pos, grad[0], *layout)
                return kh.hash_encode_fwd(table2d, pos, *layout)
            per_call.append(dict(n=int(pos.shape[0]), levels=len(layout[0]),
                                 ms=device_ms(fn)))
        out[name] = {"calls": per_call, "ms": sum(c["ms"] for c in per_call)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"port_root": str(args.port_root), "card": smi, **out}),
          flush=True)


if __name__ == "__main__":
    main()
