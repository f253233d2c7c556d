"""Command-line entry points of the port (counterpart of
``cropnerf_tpu/cli.py``), with the JAX CLI's argument names and defaults:

    python -m cropnerf_tpu_torch.cli train --method cropnerf --data ... --output ...
    python -m cropnerf_tpu_torch.cli export --run-dir ... [--num-points-per-side N]
    python -m cropnerf_tpu_torch.cli export-pointcloud --run-dir ...
    python -m cropnerf_tpu_torch.cli segment --pcd-dir ... [--vx-size V]
    python -m cropnerf_tpu_torch.cli project --run-dir ... --pcd-dir ...
    python -m cropnerf_tpu_torch.cli count --projection-dir ... --pcd-dir ...
    python -m cropnerf_tpu_torch.cli depth-project --pcd-dir ... --transforms ...
    python -m cropnerf_tpu_torch.cli depth-count --projection-dir ... --pcd-dir ...
    python -m cropnerf_tpu_torch.cli render --run-dir ... [--n-frames N]
    python -m cropnerf_tpu_torch.cli uncertainty --run-dir ... [--iters N]
    python -m cropnerf_tpu_torch.cli process-labels --seg-dir ... --out-dir ...
    python -m cropnerf_tpu_torch.cli rescale --src-dir ... --dst-dir ... --factor F
    python -m cropnerf_tpu_torch.cli segment-masks --image-dir ... --out-dir ...
    python -m cropnerf_tpu_torch.cli import-colmap --colmap-dir ... --output ...

The commands that run a model (train, export, export-pointcloud, project,
render, uncertainty) run on the card; ``CROPNERF_PLATFORM=cpu`` runs them
on the CPU, and without a card they raise.  The others are host code.  A
run directory written by either package serves the model commands, once a
JAX run's checkpoint has been converted by ``tools/jax_run_to_torch.py``,
and the counting commands read and write the JAX package's artifacts.
Not yet here: the JAX CLI's ``--multichip`` and ``--shard-bank``
(multi-GPU), ``--min-rays-per-s`` (the JAX trainer's watchdog),
``--remat`` (the port does not rematerialise), and the ``viewer``
command.
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


def _add_segment(sub):
    p = sub.add_parser("segment", help="supercluster/subcluster segmentation "
                       "(≙ segmentation/segmenter.py)")
    p.add_argument("--pcd-dir", type=Path, required=True)
    p.add_argument("--dataname", default="semantic.ply")
    p.add_argument("--k", type=int, default=2, help="subclusters per supercluster")
    p.add_argument("--vx-size", type=float, default=10e-5)


def _cmd_segment(args):
    from .counting.segmenter import process_for_pipeline
    path = process_for_pipeline(args.pcd_dir, args.dataname, args.k,
                                args.vx_size)
    print(path)
    return path


def _super_cluster_info(args):
    return np.load(Path(args.pcd_dir)
                   / f"all_super_cluster_info_nsub_{args.k}.npy",
                   allow_pickle=True)


def _add_project(sub):
    p = sub.add_parser("project", help="per-subcluster semantic projections "
                       "(≙ scripts/semantic_projection.py)")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--pcd-dir", type=Path, required=True,
                   help="dir with all_super_cluster_info_nsub_*.npy")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--output-dir", type=Path, default=None)
    p.add_argument("--label-dir", type=Path, default=None,
                   help="GT instance-label images (label_*.png) to copy")


def _cmd_project(args):
    from .projection.project import run_projections
    from .train.trainer import load_trainer_from_run

    trainer = load_trainer_from_run(args.run_dir, device=cli_device())
    info = _super_cluster_info(args)
    out_dir = args.output_dir or (Path(args.run_dir) / "projection")
    label_paths = None
    if args.label_dir is not None:
        label_paths = sorted(Path(args.label_dir).glob("*.png"))
        if not label_paths:
            raise SystemExit(f"--label-dir {args.label_dir} contains no "
                             ".png label images (expected label_*.png, one "
                             "per training camera)")
    report = run_projections(trainer.state.params, trainer.cfg.model,
                             trainer.bank.cameras, trainer.bank.height,
                             trainer.bank.width, info, out_dir,
                             label_paths=label_paths)
    print(out_dir)
    return report


def _add_count(sub):
    p = sub.add_parser("count", help="merge subclusters into instances and "
                       "count (≙ segmentation/merger.py)")
    p.add_argument("--projection-dir", type=Path, required=True)
    p.add_argument("--pcd-dir", type=Path, required=True)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--graph-partition", default="clique",
                   choices=["clique", "bridge", "community"])
    p.add_argument("--binary-threshold", type=int, default=100)
    p.add_argument("--frame-sampling-interval", type=int, default=10)
    p.add_argument("--area-normalize", action="store_true")
    p.add_argument("--attach-unlabeled", action="store_true",
                   help="evidence-free subclusters attach to the nearest "
                        "anchor instead of counting as instances")
    p.add_argument("--scale-factor", type=float, default=1.0,
                   help="label→projection resolution scale (≙ merger.py "
                        "--scale_factor): GT labels are nearest-neighbour "
                        "rescaled before scoring")
    p.add_argument("--label-dir", type=Path, default=None,
                   help="refresh per-camera label images from this "
                        "SegmentationLabel tree (label_<frame>.png)")
    p.add_argument("--orig-img-dir", type=Path, default=None,
                   help="original segmentation images for overlay debug "
                        "artifacts (≙ overly_mask_with_projection)")
    p.add_argument("--overlays", action="store_true",
                   help="write overlay debug PNGs under "
                        "super_cluster_*/overlay/")
    p.add_argument("--output-ply", type=Path, default=None)
    p.add_argument("--super-cluster-idx", type=int, default=-1,
                   help="count only this supercluster (debug; -1 = all, "
                        "≙ merger.py --super_cluster_idx); skips the "
                        "result PLY like the reference")
    p.add_argument("--n-thread", type=int, default=10,
                   help="thread-pool size over superclusters")


def _cmd_count(args):
    from .counting.merger import (MergerConfig, count_instances,
                                  write_instance_cloud)
    info = _super_cluster_info(args)
    cfg = MergerConfig(
        graph_partition=args.graph_partition,
        binary_threshold=args.binary_threshold,
        frame_sampling_interval=args.frame_sampling_interval,
        area_normalize=args.area_normalize,
        attach_unlabeled=args.attach_unlabeled,
        scale_factor=args.scale_factor,
        label_dir=args.label_dir,
        orig_img_dir=args.orig_img_dir,
        make_overlays=args.overlays,
        super_cluster_idx=args.super_cluster_idx,
        n_thread=args.n_thread)
    result = count_instances(args.projection_dir, info, cfg)
    if args.super_cluster_idx < 0:
        out_ply = (args.output_ply
                   or Path(args.pcd_dir) / "full_tree_seg_result.ply")
        write_instance_cloud(out_ply, info, result)
    elif args.output_ply is not None:
        # the reference's single-cluster mode never writes the result PLY
        # (merger.py:443-456); say so instead of silently dropping the flag
        print(f"note: --output-ply ignored with --super-cluster-idx="
              f"{args.super_cluster_idx} (single-cluster debug mode writes "
              f"no result PLY, matching the reference)", flush=True)
    print(json.dumps({"total_count": result.total_count,
                      "per_super_cluster": result.per_super_cluster}))
    return result


def _add_depth_project(sub):
    p = sub.add_parser("depth-project", help="NeRF-free z-buffer projections "
                       "(≙ scripts/depth_based_semantic_projection.py)")
    p.add_argument("--pcd-dir", type=Path, required=True,
                   help="dir with all_super_cluster_info_nsub_*.npy + clouds")
    p.add_argument("--transforms", type=Path, required=True,
                   help="transforms_train.json (see `render` camera export)")
    p.add_argument("--full-tree", type=Path, default=None,
                   help="full-tree cloud .ply (default: density.ply)")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--height", type=int, default=1440)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)


def _cmd_depth_project(args):
    from .counting.depth_projection import (DepthProjectionConfig,
                                            project_super_clusters_for_camera)
    from .export.ply import read_ply

    info = _super_cluster_info(args)
    full_tree_path = args.full_tree or (Path(args.pcd_dir) / "density.ply")
    full_tree, _ = read_ply(full_tree_path)
    meta = json.loads(Path(args.transforms).read_text())
    frames = meta["frames"] if isinstance(meta, dict) else meta
    cfg = DepthProjectionConfig(height=args.height, width=args.width)
    for i, frame in enumerate(frames):
        c2w = np.array(frame.get("transform",
                                 frame.get("transform_matrix")))[:3, :4]
        cam = {"fx": args.fx, "fy": args.fy, "cx": args.cx, "cy": args.cy,
               "c2w": c2w, "index": i}
        project_super_clusters_for_camera(cam, info, full_tree,
                                          args.output_dir, cfg)
    print(args.output_dir)
    return args.output_dir


def _add_depth_count(sub):
    p = sub.add_parser("depth-count", help="count from depth projections "
                       "(≙ segmentation/depth_projection_based_merger.py)")
    p.add_argument("--projection-dir", type=Path, required=True)
    p.add_argument("--pcd-dir", type=Path, required=True)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--graph-partition", default="community",
                   choices=["clique", "bridge", "community"])
    p.add_argument("--binary-threshold", type=int, default=100)
    p.add_argument("--frame-sampling-interval", type=int, default=10)
    p.add_argument("--super-cluster-idx", type=int, default=-1,
                   help="count only this supercluster (-1 = all)")


def _cmd_depth_count(args):
    from .counting.depth_projection import (DepthMergerConfig,
                                            count_instances_depth)
    info = _super_cluster_info(args)
    cfg = DepthMergerConfig(
        graph_partition=args.graph_partition,
        binary_threshold=args.binary_threshold,
        frame_sampling_interval=args.frame_sampling_interval,
        super_cluster_idx=args.super_cluster_idx)
    result = count_instances_depth(args.projection_dir, info, cfg)
    print(json.dumps({"total_count": result.total_count,
                      "per_super_cluster": result.per_super_cluster}))
    return result


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


def _add_process_labels(sub):
    p = sub.add_parser("process-labels", help="instance-colour PNGs → label "
                       "images (≙ utils/convert_segmentation_img_to_label.py)")
    p.add_argument("--seg-dir", type=Path, required=True)
    p.add_argument("--out-dir", type=Path, required=True)


def _cmd_process_labels(args):
    from .data.preprocess import convert_segmentation_dir
    n = convert_segmentation_dir(args.seg_dir, args.out_dir)
    print(f"converted {n} images")
    return n


def _add_rescale(sub):
    p = sub.add_parser("rescale", help="downscale an image/label directory "
                       "by an integer factor (≙ utils/rescale.py; the "
                       "reference preprocess emits 2x/4x/8x pyramids, "
                       "fruit_nerf_dataset.py:287-299)")
    p.add_argument("--src-dir", type=Path, required=True)
    p.add_argument("--dst-dir", type=Path, required=True)
    p.add_argument("--factor", type=int, required=True)
    p.add_argument("--pattern", default="*.png")
    p.add_argument("--nearest", action="store_true",
                   help="nearest-neighbour resampling (REQUIRED for label/"
                        "mask images so ids are not interpolated)")


def _cmd_rescale(args):
    from .data.preprocess import rescale_images
    n = rescale_images(args.src_dir, args.dst_dir, args.factor,
                       pattern=args.pattern, nearest=args.nearest)
    print(json.dumps({"rescaled": n, "dst": str(args.dst_dir)}))
    return n


def _add_segment_masks(sub):
    p = sub.add_parser("segment-masks", help="images → per-frame binary "
                       "fruit masks via classical colour segmentation "
                       "(dependency-free GroundedSAM stand-in; same output "
                       "format + >20%%-drop rule as "
                       "fruit_nerf_dataset.py:51-198)")
    p.add_argument("--image-dir", type=Path, required=True)
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--color", default=None,
                   help="foreground RGB prior as R,G,B (the text-prompt "
                        "stand-in); omit for priorless border-background "
                        "kmeans")
    p.add_argument("--color-tol", type=float, default=60.0)
    p.add_argument("--k", type=int, default=3,
                   help="kmeans colour clusters (k<=1 with --color = plain "
                        "distance threshold)")
    p.add_argument("--max-mask-fraction", type=float, default=0.2,
                   help="drop components above this image fraction "
                        "(reference drop rule, fruit_nerf_dataset.py:172)")
    p.add_argument("--min-area", type=int, default=16)
    p.add_argument("--morph-radius", type=int, default=1)
    p.add_argument("--update-transforms", type=Path, default=None,
                   help="transforms.json to wire per-frame semantic_path "
                        "entries into (≙ _save_transforms, "
                        "fruit_nerf_dataset.py:364-373)")


def _cmd_segment_masks(args):
    from .data.autoseg import AutoSegConfig, segment_dir
    color = (tuple(int(c) for c in args.color.split(","))
             if args.color else None)
    cfg = AutoSegConfig(color=color, color_tol=args.color_tol, k=args.k,
                        max_mask_fraction=args.max_mask_fraction,
                        min_area=args.min_area,
                        morph_radius=args.morph_radius)
    n = segment_dir(args.image_dir, args.out_dir, cfg,
                    transforms_path=args.update_transforms)
    print(json.dumps({"segmented": n, "out": str(args.out_dir),
                      "transforms_updated":
                          args.update_transforms is not None}))
    return n


def _add_import_colmap(sub):
    p = sub.add_parser("import-colmap", help="COLMAP sparse model → "
                       "transforms.json in the 3DCotton layout "
                       "(≙ the dataset builder's COLMAP step, "
                       "fruit_nerf_dataset.py:342-378)")
    p.add_argument("--colmap-dir", type=Path, required=True,
                   help="dir holding cameras.txt/.bin + images.txt/.bin")
    p.add_argument("--output", type=Path, required=True,
                   help="transforms.json path to write")
    p.add_argument("--images-rel-dir", default="images")
    p.add_argument("--semantic-rel-dir", default=None,
                   help="inject per-frame semantic_path under this dir")
    p.add_argument("--semantic-ext", default=None,
                   help="override the semantic file extension (e.g. .png)")
    p.add_argument("--semantic-classes", nargs="*", default=None)


def _cmd_import_colmap(args):
    from .data.colmap import colmap_to_transforms
    meta = colmap_to_transforms(
        args.colmap_dir, args.output,
        images_rel_dir=args.images_rel_dir,
        semantic_rel_dir=args.semantic_rel_dir,
        semantic_classes=args.semantic_classes,
        semantic_ext=args.semantic_ext)
    print(f"wrote {args.output} ({len(meta['frames'])} frames)")
    return meta


COMMANDS = {
    "train": (_add_train, _cmd_train),
    "export": (_add_export, _cmd_export),
    "export-pointcloud": (_add_export_pointcloud, _cmd_export_pointcloud),
    "segment": (_add_segment, _cmd_segment),
    "project": (_add_project, _cmd_project),
    "count": (_add_count, _cmd_count),
    "depth-project": (_add_depth_project, _cmd_depth_project),
    "depth-count": (_add_depth_count, _cmd_depth_count),
    "render": (_add_render, _cmd_render),
    "uncertainty": (_add_uncertainty, _cmd_uncertainty),
    "process-labels": (_add_process_labels, _cmd_process_labels),
    "rescale": (_add_rescale, _cmd_rescale),
    "segment-masks": (_add_segment_masks, _cmd_segment_masks),
    "import-colmap": (_add_import_colmap, _cmd_import_colmap),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cropnerf_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for add, _ in COMMANDS.values():
        add(sub)
    return parser


def main(argv=None):
    """Run one command; returns what it made: ``train`` the Trainer,
    ``project`` its ProjectionReport, ``count`` and ``depth-count`` their
    CountResult, the preprocessing commands their counts or the
    transforms they wrote, the others the paths they wrote."""
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command][1](args)


if __name__ == "__main__":
    main()
