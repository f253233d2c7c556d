"""What the trainer loop costs over the bare training step, in one process
on one NVIDIA GPU.

For ``cropnerf`` and ``cropnerf-mxu`` on ``chip_smoke.py``'s ray-traced
dataset (32 views of 1200x800), one Trainer alternates windows of
``--steps`` steps: the loop (``Trainer.train``, whose ``rays_per_s`` covers
its steps up to the last log, the one card read) and the bare step
(``trainer.train_step`` called back to back on the same state and bank,
then one synchronise).  Loop and bare windows run in turns, so both see
the same host and the same allocator state.  Run from the root of the
repository:

    python3 tools/loop_cost.py [--steps 100] [--rounds 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("loop_cost: no CUDA device is visible")
    from chip_smoke import CLI_FOCAL, CLI_IMAGES, write_cli_dataset
    from cropnerf_tpu_torch.data.dataparser import DataparserConfig
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.trainer import Trainer
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    never = 10 ** 9
    out = {"card": card, "steps": args.steps}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_cli_dataset(Path(tmp) / "data", *CLI_IMAGES, CLI_FOCAL)
        for preset in ("cropnerf", "cropnerf-mxu"):
            cfg = dataclasses.replace(
                PRESETS[preset], steps_per_eval_batch=never,
                steps_per_eval_image=never, steps_per_eval_all_images=0,
                steps_per_save=never)
            trainer = Trainer(cfg, DataparserConfig(data_dir=data),
                              Path(tmp) / preset, device=dev)
            R = cfg.train_num_rays_per_batch
            gen = torch.Generator(device=dev).manual_seed(5)
            trainer.train(num_steps=args.steps)          # warm-up
            loop, bare = [], []
            for _ in range(args.rounds):
                m = trainer.train(num_steps=args.steps,
                                  log_every=args.steps)
                loop.append(m["rays_per_s"])
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(args.steps):
                    trainer.train_step(trainer.state, trainer.bank, gen)
                torch.cuda.synchronize()
                bare.append(R * args.steps / (time.perf_counter() - t))
            out[preset] = {"loop_rays_per_s": loop, "bare_rays_per_s": bare}
            print(f"[loop_cost] {preset}: loop rays/s median "
                  f"{statistics.median(loop):.0f} ("
                  + ", ".join(f"{v:.0f}" for v in loop)
                  + f"), bare step rays/s median "
                  f"{statistics.median(bare):.0f} ("
                  + ", ".join(f"{v:.0f}" for v in bare)
                  + f"), {args.steps} steps a window; {card}", flush=True)
            del trainer
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
