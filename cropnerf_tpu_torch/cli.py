"""Command-line entry points of the port (counterpart of
``cropnerf_tpu/cli.py``), with the JAX CLI's argument names and defaults:

    python -m cropnerf_tpu_torch.cli train --method cropnerf --data ... --output ...
    python -m cropnerf_tpu_torch.cli export --run-dir ... [--num-points-per-side N]
    python -m cropnerf_tpu_torch.cli export-pointcloud --run-dir ...
    python -m cropnerf_tpu_torch.cli render --run-dir ... [--n-frames N]
    python -m cropnerf_tpu_torch.cli uncertainty --run-dir ... [--iters N]

Every command runs on the card; ``CROPNERF_PLATFORM=cpu`` runs it on the
CPU, and without a card it raises.  A run directory written by either
package serves the last four, once a JAX run's checkpoint has been
converted by ``tools/jax_run_to_torch.py``.  Not yet here: the JAX CLI's
``--multichip`` and ``--shard-bank`` (multi-GPU), ``--min-rays-per-s``
(the JAX trainer's watchdog), ``--remat`` (the port does not
rematerialise), and the commands ``segment``, ``project``, ``count``,
``depth-project``, ``depth-count``, ``process-labels``, ``rescale``,
``segment-masks``, ``import-colmap`` and ``viewer``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device


def cli_device() -> torch.device:
    """The card, or the CPU when ``CROPNERF_PLATFORM=cpu``."""
    return resolve_device(os.environ.get("CROPNERF_PLATFORM") or "cuda")


def _add_train(sub):
    p = sub.add_parser("train", help="train a semantic NeRF")
    p.add_argument("--method", default="cropnerf",
                   help="preset: cropnerf[-big|-huge] (reference-parity "
                        "hash grid) | cropnerf-mxu[-big|-huge] (PE field) | "
                        "semantic-nerf | cropnerf-tiny (CI)")
    p.add_argument("--data", type=Path, required=True,
                   help="dataset dir containing transforms.json")
    p.add_argument("--output", type=Path, required=True, help="run dir")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--semantic-dir", default="semantics")
    p.add_argument("--train-split-fraction", type=float, default=0.95)
    p.add_argument("--experiment-name", default="cropnerf")
    p.add_argument("--rays-per-batch", type=int, default=None,
                   help="override the preset's train ray batch")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run K optimizer steps per call of the step. "
                        "Cadences (log/eval/save) must be multiples of K")
    p.add_argument("--mask-threshold", default=None,
                   help="semantic-label binarisation: an int grayscale "
                        "threshold (default 3, the Cotton loader) or "
                        "'fruit' for the FruitDataset per-extension "
                        "dispatch (.jpg → 125, else any nonzero)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --output")


def _cmd_train(args):
    import dataclasses
    from .data.dataparser import DataparserConfig
    from .data.dataset import SEMANTIC_THRESHOLD
    from .models.config import PRESETS
    from .train.trainer import Trainer

    if args.method not in PRESETS:
        raise SystemExit(f"unknown method {args.method!r}; available: "
                         f"{', '.join(sorted(PRESETS))}")
    cfg = PRESETS[args.method]
    if args.rays_per_batch is not None:
        cfg = dataclasses.replace(cfg,
                                  train_num_rays_per_batch=args.rays_per_batch)
    data_cfg = DataparserConfig(
        data_dir=args.data, semantic_dir=args.semantic_dir,
        train_split_fraction=args.train_split_fraction)
    thr = args.mask_threshold
    if thr is None:
        thr = SEMANTIC_THRESHOLD
    elif thr != "fruit":
        thr = int(thr)
    trainer = Trainer(cfg, data_cfg, args.output,
                      experiment_name=args.experiment_name,
                      resume=args.resume,
                      steps_per_dispatch=args.steps_per_dispatch,
                      semantic_threshold=thr, device=cli_device())
    previous = trainer.install_signal_handlers()
    try:
        metrics = trainer.train(num_steps=args.max_steps)
    finally:
        # a caller that runs the command in its own process gets its
        # handlers back
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print(json.dumps({k: v for k, v in metrics.items()}, default=float))
    return trainer


def _add_export(sub):
    p = sub.add_parser("export", help="export semantic point clouds "
                       "(semantic-pointcloud ≙ scripts/exporter.py)")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--num-points-per-side", type=int, default=3000)
    p.add_argument("--rays-per-batch", type=int, default=512)
    p.add_argument("--render-rgb", action="store_true")
    p.add_argument("--aabb", type=float, nargs=6, default=None,
                   help="xmin ymin zmin xmax ymax zmax (default: scene box)")
    p.add_argument("--unscale", action="store_true",
                   help="apply the reference's 2/scale artifact transform "
                        "(default keeps the dataparser frame so downstream "
                        "stages stay frame-consistent)")
    p.add_argument("--semantic-threshold", type=float, default=None,
                   help="semantic logit cutoff (default 3.0, reference)")
    p.add_argument("--density-threshold", type=float, default=None,
                   help="density cutoff (default 70.0, reference)")
    p.add_argument("--colormap-threshold", type=float, default=None,
                   help="sigmoid cutoff for the colormap cloud (default 0.999)")


def _cmd_export(args):
    from .export.ply import ply_vertex_count
    from .export.volume import export_and_write
    from .train.trainer import load_trainer_from_run

    trainer = load_trainer_from_run(args.run_dir, device=cli_device())
    out_dir = args.output_dir or (Path(args.run_dir) / "exports")
    if args.aabb is not None:
        aabb = np.array(args.aabb, np.float32).reshape(2, 3)
    else:
        aabb = trainer.train_outputs.scene_box
    # dataparser frame: pass scale=2 so unscale_points(×2/2)=identity
    paths = export_and_write(
        trainer.state.params, trainer.cfg.model, aabb, out_dir,
        dataparser_scale=(trainer.train_outputs.dataparser_scale
                          if args.unscale else 2.0),
        num_points_per_side=args.num_points_per_side,
        rays_per_batch=args.rays_per_batch,
        render_rgb=args.render_rgb,
        **{k: v for k, v in (
            ("semantic_threshold", args.semantic_threshold),
            ("density_threshold", args.density_threshold),
            ("colormap_threshold", args.colormap_threshold)) if v is not None})
    for name, p in paths.items():
        n = ply_vertex_count(Path(p))
        if n == 0:
            print(f"WARNING: {name}.ply is empty — the model's density/"
                  f"semantic scale may be below the thresholds; try "
                  f"--density-threshold/--semantic-threshold", flush=True)
    print(json.dumps({k: str(v) for k, v in paths.items()}))
    return paths


def _add_export_pointcloud(sub):
    p = sub.add_parser(
        "export-pointcloud",
        help="depth-based semantic point cloud (≙ `ns-export pointcloud "
             "--num-points 10000000`)")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None,
                   help="output .ply (default <run>/exports/semantics_pc.ply)")
    p.add_argument("--num-points", type=int, default=1_000_000)
    p.add_argument("--rays-per-batch", type=int, default=16384)
    p.add_argument("--all-points", action="store_true",
                   help="keep every surface point, not just semantic-"
                        "positive rays (≙ only_semantics=False)")
    p.add_argument("--semantic-threshold", type=float, default=0.5,
                   help="semantics_colormap cutoff for kept rays")
    p.add_argument("--accumulation-threshold", type=float, default=0.5)
    p.add_argument("--keep-outliers", action="store_true",
                   help="skip statistical outlier removal")
    p.add_argument("--std-ratio", type=float, default=10.0)
    p.add_argument("--normals-k", type=int, default=None,
                   help="estimate PCA normals over k neighbours (slow on "
                        "large clouds; reference estimates with k=10)")
    p.add_argument("--unscale", action="store_true",
                   help="apply the reference's 2/scale artifact transform")
    p.add_argument("--seed", type=int, default=0)


def _cmd_export_pointcloud(args):
    from .export.ply import ply_vertex_count
    from .export.pointcloud import export_depth_pointcloud
    from .train.trainer import load_trainer_from_run

    trainer = load_trainer_from_run(args.run_dir, device=cli_device())
    out = args.output or (Path(args.run_dir) / "exports" / "semantics_pc.ply")
    scale = (2.0 / trainer.train_outputs.dataparser_scale
             if args.unscale else 1.0)
    path = export_depth_pointcloud(
        trainer.state.params, trainer.cfg.model, trainer.bank, out,
        normals_k=args.normals_k, scale_factor=scale,
        num_points=args.num_points, rays_per_batch=args.rays_per_batch,
        only_semantics=not args.all_points,
        semantic_threshold=args.semantic_threshold,
        accumulation_threshold=args.accumulation_threshold,
        remove_outliers=not args.keep_outliers, std_ratio=args.std_ratio,
        seed=args.seed)
    n = ply_vertex_count(Path(path))
    if n == 0:
        print("WARNING: semantics_pc.ply is empty — lower "
              "--semantic-threshold/--accumulation-threshold or pass "
              "--all-points for an under-trained model", flush=True)
    print(json.dumps({"semantics_pc": str(path), "num_points": n}))
    return path


def _add_render(sub):
    p = sub.add_parser("render", help="render an orbit video / eval images")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--radius", type=float, default=1.2)
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--channel", default="rgb",
                   choices=["rgb", "semantics_colormap", "depth",
                            "accumulation"])
    p.add_argument("--eval-metrics", action="store_true",
                   help="also print averaged eval-image metrics")
    p.add_argument("--export-cameras", action="store_true",
                   help="write transforms_train/eval.json with camera-opt-"
                        "adjusted train poses (≙ ExportCameraPoses; "
                        "consumed by depth-project)")


def _cmd_render(args):
    from .evaluation.render_video import (export_camera_poses,
                                          render_orbit_video)
    from .train.trainer import cameras_from_outputs, load_trainer_from_run

    trainer = load_trainer_from_run(args.run_dir, device=cli_device())
    if args.export_cameras:
        paths = export_camera_poses(
            args.run_dir,
            cameras_from_outputs(trainer.train_outputs, trainer.device),
            trainer.eval_cameras,
            pose_adjustment=trainer.state.params.camera_opt)
        print(json.dumps({k: str(v) for k, v in paths.items()}))
    out = args.output or (Path(args.run_dir) / "orbit.mp4")
    path = render_orbit_video(trainer.state.params, trainer.cfg, out,
                              n_frames=args.n_frames, radius=args.radius,
                              size=args.size, channel=args.channel)
    print(path)
    if args.eval_metrics:
        print(json.dumps(trainer.eval_all_images(), default=float))
    return path


def _add_uncertainty(sub):
    p = sub.add_parser("uncertainty", help="BayesRays hessian computation "
                       "(≙ bayesrays/uncertainty.py)")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--lod", type=int, default=8)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--rays-per-batch", type=int, default=4096)
    p.add_argument("--channel", default="semantics",
                   choices=["semantics", "rgb"])
    p.add_argument("--output", type=Path, default=None)


def _cmd_uncertainty(args):
    from .train.trainer import load_trainer_from_run
    from .uncertainty.bayesrays import ComputeUncertainty, bank_ray_batches

    trainer = load_trainer_from_run(args.run_dir, device=cli_device())
    m = trainer.cfg.model
    batches = bank_ray_batches(
        trainer.bank, m, args.iters, args.rays_per_batch,
        torch.Generator(device=trainer.device).manual_seed(0))
    comp = ComputeUncertainty(trainer.state.params, m, lod=args.lod,
                              channel=args.channel)
    out = args.output or (Path(args.run_dir) / "unc.npy")
    comp.run(batches, save_path=out)
    print(out)
    return out


COMMANDS = {
    "train": (_add_train, _cmd_train),
    "export": (_add_export, _cmd_export),
    "export-pointcloud": (_add_export_pointcloud, _cmd_export_pointcloud),
    "render": (_add_render, _cmd_render),
    "uncertainty": (_add_uncertainty, _cmd_uncertainty),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cropnerf_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for add, _ in COMMANDS.values():
        add(sub)
    return parser


def main(argv=None):
    """Run one command; returns what it made (``train``: the Trainer; the
    others: the paths they wrote)."""
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command][1](args)


if __name__ == "__main__":
    main()
