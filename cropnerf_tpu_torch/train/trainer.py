"""Training engine: loop, eval cadence, checkpointing, logging (counterpart
of ``cropnerf_tpu/train/trainer.py``).

The constructor parses the train and eval splits, puts both pixel banks on
the card, creates the train state, checks the cadences against
``steps_per_dispatch``, builds the step and writes the run metadata
(``run_config.json`` and ``dataparser_transforms.json``, field for field
as the JAX package writes them, so that runs of either package describe
the same model and frame).  The loop logs every ``log_every`` steps and on
the last; only those steps read values from the card.  Checkpoints are
``torch.save`` files, ``checkpoints/step-{step:09d}.pt``, holding the
parameters, each optimizer's state and the step; a JAX run's orbax
checkpoint becomes one through ``tools/jax_run_to_torch.py``.

The throughput watchdog (``min_rays_per_s``, off by default) holds each
clean logging window to a floor of rays/s, as the JAX trainer's does: a
window that holds the first steps (the kernels' build at first use) or a
rebuild, or eval or save work, is exempt.  Below the floor it rebuilds
the train step, at most ``_MAX_SLOW_RETRIES`` times, then warns once that
it gives up.  JAX re-jits there against its compiler's slow executables.
On the card that rebuild is a no-op: there is no compiler to run again,
and the step function keeps no state between calls, so the new step
computes what the old one did at the same speed.  The port keeps it so
that the watchdog's bookkeeping (the retries, the exempt window after
each, the three messages) is the JAX trainer's.

Across ranks (``mesh``, one process per rank) the step averages the
gradients over the ranks; the bank is replicated, or sharded by image
(``shard_bank``: each rank loads only its own images).  Rank 0 alone
writes the logs, ``run_config.json``, the eval images and the
checkpoints, and every save is followed by a barrier; the eval cadences
run on rank 0 while the others wait at a barrier (JAX's one-process mesh
shards the eval render instead).  Every rank resumes from the same
checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.cameras import Cameras
from ..data.databank import (PixelBank, build_pixel_bank,
                             build_sharded_pixel_bank, pad_cameras,
                             padded_num_images, process_image_range)
from ..data.dataparser import DataparserConfig, DataparserOutputs, parse_transforms
from ..data.dataset import SEMANTIC_THRESHOLD, load_split
from ..device import resolve_device
from ..models.config import TrainConfig, train_config_from_dict
from ..ops import metrics as metric_ops
from ..parallel.dist import barrier
from ..parallel.mesh import Mesh, main_rank
from ..utils.writer import MetricsWriter
from .state import TrainState, create_train_state
from .step import (make_eval_batch_fn, make_render_fn,
                   make_sharded_train_step, make_train_step)

# bound on the watchdog's rebuilds of the train step in one run
_MAX_SLOW_RETRIES = 2


def cameras_from_outputs(out: DataparserOutputs,
                         device: torch.device | str = "cuda") -> Cameras:
    """The parsed split's cameras on ``device``."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Cameras(
        c2w=t(out.c2w), fx=t(out.fx), fy=t(out.fy), cx=t(out.cx),
        cy=t(out.cy), width=t(out.width), height=t(out.height),
        distortion=(t(out.distortion)
                    if np.abs(out.distortion).max() > 0 else None))


class Trainer:
    """Trains one model on one GPU (or the CPU), or on the ranks of
    ``mesh``, each on its own device (``mesh.device``)."""

    def __init__(self, cfg: TrainConfig, data_config: DataparserConfig,
                 output_dir: Path, experiment_name: str = "cropnerf",
                 resume: bool = False, steps_per_dispatch: int = 1,
                 num_images_override: Optional[int] = None,
                 semantic_threshold: "int | str" = SEMANTIC_THRESHOLD,
                 device: torch.device | str = "cuda",
                 mesh: Optional[Mesh] = None,
                 shard_bank: Optional[bool] = None,
                 min_rays_per_s: Optional[float] = None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.data_config = data_config
        self.output_dir = Path(output_dir)
        self.experiment_name = experiment_name
        self.is_main = main_rank(self.mesh)
        # sharded bank: default on when the ranks span several nodes (each
        # node then loads only its ranks' images, the reference's per-rank
        # datamanager); opt-in on one node
        if shard_bank is None:
            shard_bank = self.mesh is not None and self.mesh.nodes > 1
        self.shard_bank = bool(shard_bank and self.mesh is not None)

        self.semantic_threshold = semantic_threshold
        self.train_outputs = parse_transforms(data_config, "train")
        self.eval_outputs = parse_transforms(data_config, "eval")
        self.bank: PixelBank = self._build_train_bank()
        self.eval_images, self.eval_masks = load_split(
            self.eval_outputs, semantic_threshold=semantic_threshold)
        self.eval_cameras = cameras_from_outputs(self.eval_outputs,
                                                 self.device)
        self.eval_bank: PixelBank = build_pixel_bank(
            self.eval_images, self.eval_masks, self.eval_cameras, self.device)

        # num_images_override: rebuild the per-image params (appearance
        # embedding, camera-opt) at a run's recorded image count
        self.num_train_images = int(num_images_override
                                    or self.bank.num_images)
        self.state: TrainState = create_train_state(
            cfg, self.num_train_images,
            torch.Generator().manual_seed(cfg.seed), self.device)
        # steps_per_dispatch > 1 runs that many optimizer steps per call of
        # the step; the eval and save cadences must fall on call boundaries
        k = int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch={k} must be >= 1")
        for name, cadence in (("steps_per_eval_batch", cfg.steps_per_eval_batch),
                              ("steps_per_eval_image", cfg.steps_per_eval_image),
                              ("steps_per_save", cfg.steps_per_save)):
            if cadence % k:
                raise ValueError(f"{name}={cadence} must be a multiple of "
                                 f"steps_per_dispatch={k}")
        self.steps_per_dispatch = k
        if self.shard_bank and k != 1:
            raise ValueError("steps_per_dispatch > 1 is not wired for "
                             "sharded banks")
        self.train_step = self._build_train_step()
        # the throughput watchdog's floor and state; each rank keeps its
        # own (a rebuild has no collective) and rank 0 alone prints
        self.min_rays_per_s = min_rays_per_s
        self._slow_retries = 0
        self._busy_windows = 0
        self._warned_busy_windows = False
        self._watchdog_gave_up = False
        self.eval_batch_fn = make_eval_batch_fn(cfg)
        self.render = make_render_fn(cfg)
        # the loop's draws; a resume does not restore them (nor does JAX's)
        self._loop_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        self.ckpt_dir = self.output_dir / "checkpoints"
        self.output_dir.mkdir(parents=True, exist_ok=True)
        # the metrics writer opens at the first write (a command that only
        # serves the run writes no log)
        self.writer: Optional[MetricsWriter] = None
        if self.is_main:
            self._write_run_metadata()
        self._stop_requested = False
        if resume:
            ckpts = sorted(self.ckpt_dir.glob("step-*"))
            if ckpts:
                self.load_checkpoint(ckpts[-1])
                print(f"resumed from {ckpts[-1].name} "
                      f"(step {self.state.step})", flush=True)

    def _build_train_step(self):
        if self.shard_bank:
            return make_sharded_train_step(self.cfg, self.mesh)
        return make_train_step(self.cfg, num_inner=self.steps_per_dispatch,
                               mesh=self.mesh)

    def _build_train_bank(self) -> PixelBank:
        cams = cameras_from_outputs(self.train_outputs, self.device)
        if not self.shard_bank:
            images, masks = load_split(
                self.train_outputs,
                semantic_threshold=self.semantic_threshold)
            return build_pixel_bank(images, masks, cams, self.device)
        # the frame list padded to the mesh size; this rank loads only its
        # contiguous slice of it
        n = len(self.train_outputs.image_paths)
        n_pad = padded_num_images(n, self.mesh.size)
        sel = np.arange(n_pad) % n
        lo, hi = process_image_range(n_pad, self.mesh)
        images, masks = load_split(self.train_outputs, indices=sel[lo:hi],
                                   semantic_threshold=self.semantic_threshold)
        return build_sharded_pixel_bank(
            images, masks, pad_cameras(cams, self.mesh.size), self.mesh)

    def _write(self, step: int, metrics: Dict[str, float],
               prefix: str = "train") -> None:
        """Log ``metrics`` on rank 0."""
        if not self.is_main:
            return
        if self.writer is None:
            self.writer = MetricsWriter(self.output_dir / "logs")
        self.writer.write(step, metrics, prefix=prefix)

    def install_signal_handlers(self) -> dict:
        """Graceful preemption: SIGTERM/SIGINT request a stop; the train
        loop checkpoints and returns instead of dying mid-step.  Returns
        the handlers they replace, signal → handler, for the caller to
        put back once training is over."""
        import signal

        def _handler(signum, frame):
            self._stop_requested = True
            print(f"signal {signum}: finishing step and checkpointing...",
                  flush=True)

        return {sig: signal.signal(sig, _handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    # -- checkpointing --

    def _write_run_metadata(self) -> None:
        meta = {
            "experiment_name": self.experiment_name,
            "num_train_images": self.num_train_images,
            "shard_bank": self.shard_bank,
            "semantic_threshold": self.semantic_threshold,
            "config": dataclasses.asdict(self.cfg),
            "data_config": {k: str(v) for k, v in
                            dataclasses.asdict(self.data_config).items()},
            "dataparser_transform":
                self.train_outputs.dataparser_transform.tolist(),
            "dataparser_scale": self.train_outputs.dataparser_scale,
        }
        (self.output_dir / "run_config.json").write_text(
            json.dumps(meta, indent=2, default=str))
        # exporter-compatible transforms file (scripts/exporter.py:100-101)
        (self.output_dir / "dataparser_transforms.json").write_text(json.dumps({
            "transform": self.train_outputs.dataparser_transform.tolist(),
            "scale": self.train_outputs.dataparser_scale,
        }, indent=2))

    def save_checkpoint(self) -> Path:
        """Params, every optimizer's moments and the step, written to a
        hidden file and renamed, so a checkpoint is whole or absent.  Rank
        0 writes it (the ranks hold the same state) and every rank waits
        for it."""
        step = self.state.step
        path = self.ckpt_dir / f"step-{step:09d}.pt"
        if self.is_main:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            tmp = self.ckpt_dir / f".{path.name}.tmp"
            torch.save({"params": self.state.params.state_dict(),
                        "optimizers": self.state.optimizer.state_dict(),
                        "step": step}, tmp)
            os.replace(tmp, path)
        if self.mesh is not None:
            barrier(f"save step {step}", self.mesh)
        return path

    def load_checkpoint(self, path: Path) -> None:
        path = Path(path)
        if path.is_dir():
            raise ValueError(
                f"{path} is a JAX (orbax) checkpoint; convert the run first "
                f"with tools/jax_run_to_torch.py --run-dir {path.parent.parent}")
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.state.params.load_state_dict(ckpt["params"])
        if "optimizers" in ckpt:
            self.state.optimizer.load_state_dict(ckpt["optimizers"])
        else:
            # a converted run without optimizer moments: params-only resume
            print(f"{path.name} holds no optimizer state: the optimizer "
                  f"starts fresh", flush=True)
        self.state.step = int(ckpt["step"])

    # -- eval --

    def eval_image(self, eval_idx: int = 0,
                   save_dir: Optional[Path] = None) -> Dict[str, float]:
        h = int(self.eval_outputs.height[eval_idx])
        w = int(self.eval_outputs.width[eval_idx])
        out = self.render(self.state.params, self.eval_cameras, eval_idx,
                          h, w)
        gt = torch.from_numpy(self.eval_images[eval_idx]).to(
            self.device).float() / 255.
        mask_gt = torch.from_numpy(self.eval_masks[eval_idx]).to(
            self.device).float()
        m = {
            "eval_psnr": float(metric_ops.psnr(out["rgb"], gt)),
            "eval_ssim": float(metric_ops.ssim(out["rgb"], gt)),
            # the IoU of the 0.9-binarised semantic map
            "eval_iou": float(metric_ops.binary_iou(
                out["semantics_colormap"][..., 0], mask_gt,
                threshold=0.9)),
        }
        lp = self._lpips(out["rgb"], gt)
        if lp is not None:
            m["eval_lpips"] = lp
        if save_dir is not None:
            from ..evaluation.vis import save_eval_images
            save_eval_images(save_dir,
                             {k: v.cpu().numpy() for k, v in out.items()},
                             np.asarray(self.eval_images[eval_idx]),
                             np.asarray(self.eval_masks[eval_idx]))
        return m

    def _lpips(self, pred, gt) -> Optional[float]:
        """LPIPS when weights are available; None (reported as unavailable)
        otherwise."""
        from ..ops.lpips import lpips, lpips_available
        if not lpips_available():
            if not getattr(self, "_lpips_warned", False):
                print("eval: lpips unavailable (no VGG weights; set "
                      "CROPNERF_LPIPS_WEIGHTS) — reporting PSNR/SSIM/IoU "
                      "only", flush=True)
                self._lpips_warned = True
            return None
        return float(lpips(pred, gt))

    def eval_batch(self, seed: int = 0) -> Dict[str, float]:
        """Loss/PSNR on a random eval ray batch drawn with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        m = self.eval_batch_fn(self.state.params, self.eval_bank, gen)
        return {f"eval_batch_{k}": float(v) for k, v in m.items()}

    def eval_all_images(self) -> Dict[str, float]:
        """Average metrics over every eval image."""
        n = len(self.eval_images)
        acc: Dict[str, float] = {}
        for i in range(n):
            m = self.eval_image(i)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + v
        return {k: v / n for k, v in acc.items()}

    # -- main loop --

    def train(self, num_steps: Optional[int] = None,
              log_every: int = 100) -> Dict[str, float]:
        cfg = self.cfg
        total = num_steps or cfg.max_num_iterations
        k = self.steps_per_dispatch
        if total % k:
            raise ValueError(f"num_steps={total} must be a multiple of "
                             f"steps_per_dispatch={k}")
        if log_every % k and k != 1:
            raise ValueError(f"log_every={log_every} must be a multiple of "
                             f"steps_per_dispatch={k}")
        last_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        rays_done = 0
        # the window rate covers the training calls since the last log; the
        # window is re-armed after that step's eval and save work.  The
        # first window (the kernels' build at first use) and the one after
        # a rebuild (win_rebuilt), and any window that held eval or save
        # work (win_busy), are exempt from the watchdog's floor
        t_win, rays_win, win_rebuilt, win_busy = t0, 0, True, False
        for i in range(total // k):
            if self._stop_requested:
                break
            self.state, metrics = self.train_step(self.state, self.bank,
                                                  self._loop_gen)
            rays_done += cfg.train_num_rays_per_batch * k
            rays_win += cfg.train_num_rays_per_batch * k
            step = self.state.step
            did_log = step % log_every == 0 or i == total // k - 1
            if did_log:
                # float() waits for the card, so the rates below count
                # executed (not queued) steps
                m = {key: float(v) for key, v in metrics.items()}
                now = time.perf_counter()
                m["rays_per_s"] = rays_done / max(now - t0, 1e-9)
                m["rays_per_s_window"] = rays_win / max(now - t_win, 1e-9)
                m["step"] = step
                last_metrics = m
                self._write(step, m)
                if self.is_main:
                    print(f"[step {step}] loss={m['loss']:.4f} "
                          f"psnr={m['psnr']:.2f} "
                          f"rays/s={m['rays_per_s']:.0f}", flush=True)
                win_rebuilt = self._watchdog(step, m["rays_per_s_window"],
                                             win_rebuilt, win_busy)
            # the eval cadences run on rank 0; the other ranks wait
            due = step > 0 and (
                step % cfg.steps_per_eval_batch == 0,
                step % cfg.steps_per_eval_image == 0,
                cfg.steps_per_eval_all_images > 0
                and step % cfg.steps_per_eval_all_images == 0)
            if due and due[0] and self.is_main:
                eb = self.eval_batch(seed=step)
                last_metrics.update(eb)
                self._write(step, eb, prefix="eval")
            if due and due[1] and self.is_main:
                em = self.eval_image(0, save_dir=self.output_dir /
                                     "eval_images" / f"step_{step:09d}")
                last_metrics.update(em)
                self._write(step, em, prefix="eval")
                print(f"[step {step}] eval "
                      f"psnr={last_metrics['eval_psnr']:.2f} "
                      f"iou={last_metrics['eval_iou']:.3f}", flush=True)
            if due and due[2] and self.is_main:
                ea = self.eval_all_images()
                last_metrics.update({f"all_{key}": v for key, v in ea.items()})
                self._write(step, ea, prefix="eval_all")
            if due and any(due):
                win_busy = True
                if self.mesh is not None:
                    barrier(f"eval step {step}", self.mesh)
            if step % cfg.steps_per_save == 0 and step > 0:
                self.save_checkpoint()
                win_busy = True
            if did_log:
                t_win, rays_win, win_busy = time.perf_counter(), 0, False
        # full eval at the end of training, on rank 0
        if not self._stop_requested and self.is_main:
            ea = self.eval_all_images()
            last_metrics.update({f"all_{key}": v for key, v in ea.items()})
            self._write(self.state.step, ea, prefix="eval_all")
            print("[final] " + " ".join(f"{key}={v:.3f}"
                                        for key, v in ea.items()), flush=True)
        if self.mesh is not None:
            barrier("final eval", self.mesh)
        self.save_checkpoint()
        return last_metrics

    def _watchdog(self, step: int, rate: float, rebuilt: bool,
                  busy: bool) -> bool:
        """The throughput watchdog at a logging window of ``rate`` rays/s
        that held the first steps or a rebuild (``rebuilt``), or eval or
        save work (``busy``).  Returns whether it rebuilt the step, which
        exempts the next window."""
        floor = self.min_rays_per_s
        if floor is None:
            return False
        # an eval or save cadence at or below the logging cadence exempts
        # every window, which turns the floor off: say so once
        self._busy_windows = self._busy_windows + 1 if busy else 0
        if self._busy_windows == 10 and not self._warned_busy_windows:
            self._warned_busy_windows = True
            self._say("[watchdog] NOTE: the last 10 logging windows all "
                      "contained eval/save work and were exempted from the "
                      "throughput floor — the watchdog is effectively "
                      "disabled at this eval/log cadence; raise log_every "
                      "or lower the eval cadence to re-arm it")
        if rebuilt or busy or rate >= floor:
            return False
        if self._slow_retries < _MAX_SLOW_RETRIES:
            self._slow_retries += 1
            self._say(f"[step {step}] WATCHDOG: window throughput "
                      f"{rate:.0f} rays/s < floor {floor:.0f} — rebuilding "
                      f"the train step (retry {self._slow_retries}/"
                      f"{_MAX_SLOW_RETRIES})")
            self.train_step = self._build_train_step()
            return True
        if not self._watchdog_gave_up:
            self._watchdog_gave_up = True
            self._say(f"[step {step}] WATCHDOG: still below floor "
                      f"({rate:.0f} < {floor:.0f} rays/s) after "
                      f"{_MAX_SLOW_RETRIES} rebuilds — giving up; run "
                      f"continues at reduced throughput")
        return False

    def _say(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)


def load_trainer_from_run(run_dir: Path,
                          device: torch.device | str = "cuda",
                          mesh: Optional[Mesh] = None) -> Trainer:
    """A Trainer (model, data and the latest checkpoint) from a run
    directory written by either package; a JAX run's checkpoint must have
    been converted by ``tools/jax_run_to_torch.py``.  With ``mesh`` every
    rank loads the whole run on its own device (a replicated bank) and
    rank 0 alone rewrites the run's metadata."""
    run_dir = Path(run_dir)
    meta = json.loads((run_dir / "run_config.json").read_text())
    cfg = train_config_from_dict(meta["config"])
    dc = meta["data_config"]
    data_config = DataparserConfig(
        data_dir=Path(dc["data_dir"]),
        train_split_fraction=float(dc["train_split_fraction"]),
        semantic_dir=dc["semantic_dir"])
    if mesh is not None:
        # every rank has read the metadata before rank 0 rewrites it
        barrier("run_config.json read", mesh)
    trainer = Trainer(cfg, data_config, run_dir,
                      experiment_name=meta.get("experiment_name", "cropnerf"),
                      num_images_override=meta.get("num_train_images"),
                      semantic_threshold=meta.get("semantic_threshold",
                                                  SEMANTIC_THRESHOLD),
                      device=device, mesh=mesh, shard_bank=False)
    ckpts = sorted((run_dir / "checkpoints").glob("step-*"))
    if ckpts:
        trainer.load_checkpoint(ckpts[-1])
    return trainer
