"""Loss terms of a short training run on the CPU, in the JAX package or in
the PyTorch port, on a small copy of ``chip_smoke.py``'s ray-traced
dataset (32 views of 120x80, three spheres).

It prints each logged step's loss, RGB, semantic, interlevel and
distortion terms and PSNR, then the held-out view's metrics after the
last step (``eval_all_images``: PSNR, SSIM, IoU), so that a trend seen
in ``chip_smoke.py``'s ``[cli]`` phase can be held against the JAX
package on the same data.  Run from the root of the repository, one
package per process:

    JAX_PLATFORMS=cpu python tools/loss_terms.py --package jax
    python tools/loss_terms.py --package torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TERMS = ("loss", "rgb_loss", "semantics_loss", "interlevel_loss",
         "distortion_loss", "psnr")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", choices=["jax", "torch"], required=True)
    parser.add_argument("--preset", default="cropnerf-mxu")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--rays", type=int, default=512)
    parser.add_argument("--log-every", type=int, default=50)
    args = parser.parse_args()

    from chip_smoke import write_cli_dataset
    if args.package == "jax":
        from cropnerf_tpu.data.dataparser import DataparserConfig
        from cropnerf_tpu.models.config import PRESETS
        from cropnerf_tpu.train.trainer import Trainer
        kw = {}
    else:
        from cropnerf_tpu_torch.data.dataparser import DataparserConfig
        from cropnerf_tpu_torch.models.config import PRESETS
        from cropnerf_tpu_torch.train.trainer import Trainer
        kw = {"device": "cpu"}
    never = 10 ** 9
    cfg = dataclasses.replace(
        PRESETS[args.preset], train_num_rays_per_batch=args.rays,
        steps_per_eval_batch=never, steps_per_eval_image=never,
        steps_per_eval_all_images=0, steps_per_save=never,
        eval_num_rays_per_chunk=4096)
    with tempfile.TemporaryDirectory() as tmp:
        data = write_cli_dataset(Path(tmp) / "data", 32, 80, 120, 100.0)
        trainer = Trainer(cfg, DataparserConfig(data_dir=data),
                          Path(tmp) / "run", **kw)
        trainer.train(num_steps=args.steps, log_every=args.log_every)
        for line in (Path(tmp) / "run" / "logs" / "metrics.jsonl").open():
            rec = json.loads(line)
            if "train/loss" in rec:
                print(json.dumps({"step": rec["step"], **{
                    k: rec[f"train/{k}"] for k in TERMS}}), flush=True)
        print(json.dumps({"step": args.steps,
                          "heldout": trainer.eval_all_images()}), flush=True)


if __name__ == "__main__":
    main()
