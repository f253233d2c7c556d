#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cropnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

1. builds the CUDA kernels from cropnerf_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, started together) and prints each kernel's
   registers, shared memory and spills, then the native point-cloud ops
   (make, g++) from cropnerf_tpu_torch/native;
2. prints the card (torch and nvidia-smi: name, power limit);
3. holds every kernel against its plain PyTorch version at the shapes the
   serving and training paths give it and at a ragged N, and times both:
   for cropnerf-mxu K1 forward and backward (the backward against autograd
   of the plain version), K2 and K3 forward and backward (the backwards at
   the BayesRays batch, with and without weight gradients; K3 per head on
   its wgmma kernels, at an export chunk or a BayesRays batch, the tiles'
   edges, a ragged N and an x or g off 16-byte alignment, two runs
   bit-identical, for cropnerf-mxu's 64-wide heads and for -big's and
   -huge's 128- and 256-wide ones (each at its preset's BayesRays batch),
   each route's launches counted apart; K1's and K2's
   forward over three profiler windows, also under the schedule the port
   does not use (its two warpgroups together instead of out of phase),
   which must give the same bits, and their backward pass by pass, tile,
   dW and sums, over three windows, each with its registers and spills;
   two runs of each give the same bits); for cropnerf
   (the hash-grid field, the CLI default) the hash-grid encode K4 forward
   and backward at the field's and both proposal nets' shapes, a ragged N
   and a small dense [L, T, F] table (the forward bit for bit, over three
   profiler windows, with the distinct 32-byte sectors its gathers touch
   and their time at the rate a PyTorch index_select gathers 8-byte
   rows, which the kernel beats: no floor); the fused PE proposal nets K5 forward and backward
   (csrc/fused_pe_mlp_fwd.cu and csrc/fused_pe_mlp_bwd.cu; the backward
   with dx and the weight gradients) at both nets' training shapes, a
   ragged N and N < 64, each over three profiler windows; K5's wide route
   (the PE variants of
   csrc/fused_mlp_fwd.cu and csrc/fused_mlp_bwd.cu) at cropnerf-mxu-q's
   128-wide nets, forward and backward (dx with dW, and dW alone) at a
   training step's shapes, a ragged N, N < 64, one row and none, with
   exact launches, two runs bit-identical, registers and spills (none
   allowed); the stream route of K3 and K5 (csrc/fused_mlp_stream.cu,
   the nets the resident-weight kernels do not take) at -huge's semantic
   head 256 wide (an export chunk, its BayesRays batch), at a 3-layer
   256-wide net no preset builds, at [prop256]'s 256-wide proposal nets
   (a training step's batches) and at a 4-layer net 64 wide, forward,
   backward with dx and dW, dx alone and dW alone, a ragged N and N = 1,
   against the plain version, by pass, with exact launches, two runs
   bit-identical, registers and spills (none allowed); the transmittance
   scan K6 at a training
   step's three compositing shapes, at [16384, 3000] and at a ragged shape,
   called through its own entry point with its launches counted (no model
   path calls it);
4. drives the serving paths with random weights from a seeded
   torch.Generator at full published widths: forward at 4096 rays, a
   256x256 render (two 32,768-ray chunks) and a 128^3 volume export with
   colours, with the launch counts zeroed just before each and read just
   after (the export's K3 launches exactly: each head once a chunk, all
   on the wgmma kernels); then runs the same calls with the kernels' plain
   versions and compares.
   cropnerf-mxu first, then cropnerf, whose launch counts are checked
   exactly for each call;
5. drives the training paths: a pixel bank of 32 synthetic 1200x800
   images resident on the card, 4096 rays a step; one step on the kernel
   path against one on the plain path from the same parameters and draws,
   then a first step and TRAIN_STEPS timed steps with the launch counts
   zeroed before and read after; for cropnerf then one step between
   proposal updates (the proposal nets run without a graph), and K4's
   backward on the positions and cotangents of one training step's three
   calls (tools/hash_bwd_real_step.py captures them), against its plain
   version and timed beside the uniform positions, and K4's forward on the
   same positions, bit for bit, timed, with their sectors;
5b. drives the BayesRays pass on the same bank ([uncertainty] lines): the
   Hessian at lod 8 over UNC_BATCHES batches of 4096 rays, semantics
   channel, for cropnerf-mxu (K2 and K3 forward and backward, dx only; then
   one rgb-channel batch) and cropnerf (K4 forward and its dpos-only
   backward), with exact launch counts and the grid held against the plain
   path; then the per-ray uncertainty and a 256x256 render filtered at
   uncertainty 0.5 through make_render_fn's density hook;
5c. drives cropnerf-mxu with both PE proposal nets on the fused kernel
   ([propfused] lines, the configuration benchmarks/ab_pe_fused.py builds):
   forward and the 256x256 render, 1 + TRAIN_STEPS training steps, each
   held against a plain step from its state and draws (loss, gradient,
   update), and the depth point cloud at
   16,384 rays a batch up to 1,000,000 points (thresholds at a first
   batch's medians), each with exact launch counts of K1 and K5;
5c'. drives cropnerf-mxu-q at its published widths and batch ([mxuq]
   lines): the published preset (proposal nets on plain matmuls) forward,
   the 256x256 render and the 128^3 export against the all-plain path and
   1 + TRAIN_STEPS training steps, each held against an all-plain step
   from its state; then its fused-proposal variant (K5's wide route)
   through the [propfused] phase: forward, render, training steps (2 + 2
   K5 launches a step) and one depth-cloud batch, launches exact;
5c''. drives [prop256] ([prop256] lines): cropnerf-mxu-q with both PE
   proposal nets fused and 256 wide (K5's stream route) through the
   [propfused] phase: forward at 4096 rays, the 256x256 render, 1 +
   TRAIN_STEPS training steps and one 16,384-ray depth-cloud batch, each
   against the plain path, launches exact; then cropnerf-mxu-huge with a
   256-wide semantic head (K3's stream route): the 64^3 export with
   colours against the same export with K3's plain version and one
   BayesRays batch on the semantics channel against the plain path;
5d. drives the CLI in process, cli.main([...]) ([cli] lines), on a
   ray-traced 3DCotton-layout dataset of 32 views of 1200x800 (for
   cropnerf, whose count is not held, the same scene at 600x400): for
   cropnerf train --max-steps 500 (an eval batch, an eval image and the save at step
   500, then the full eval), train --resume --max-steps 20, export at 128^3
   (thresholds from the trained field's quantiles), uncertainty at lod 8
   over 8 batches and render (2 frames of 256x256, --eval-metrics); for
   cropnerf-mxu the same with export-pointcloud (1,000,000 points) in
   place of render.  It checks each command's kernels launched (counts
   zeroed just before it), the loss falling, finite eval metrics, the
   checkpoint bit for bit through load_trainer_from_run, the CLI's export
   row for row against a direct export_and_write and the run directory's
   files, and prints each command's wall seconds, the loop's rays/s beside
   the bare step's and the checkpoint's size and save time.  Without
   matplotlib (the eval-image PNGs need it) train runs through the Trainer
   API with the eval image moved past the run, and the phase says so;
5e. drives the counting pipeline through the CLI on the [cli] runs
   ([count] lines), for cropnerf and cropnerf-mxu: export over the plant's
   box at 256 a side with the reference's thresholds → segment → project
   (every training camera, the training split's instance labels) → count,
   cropnerf-mxu's count held to the scene's two crops (cropnerf's printed:
   its field keeps semantic haze on this scene); for cropnerf then render
   --export-cameras, export-pointcloud --all-points, depth-project,
   depth-count, process-labels, rescale --nearest, segment-masks and
   import-colmap once each.  Each project's launches are held exactly to
   its plan (K4 forward six times a dispatch; K1 and K2 forward once
   each), its kernel path against the plain path on one subcluster from
   three cameras, its PNG tree for completeness, and the native
   point-cloud backend (built in step 1 from cropnerf_tpu_torch/native)
   must be the one that ran.  cropnerf's export, segment and project run
   on two ranks under torchrun (export --multichip, project --multichip:
   rank r takes chunks and dispatches r, r+2, ...), each rank's launches
   counted: the export byte for byte against one process's
   export_and_write, the PNGs of supercluster 0's subcluster 0 from
   cameras 0, 10 and 20 byte for byte against one process's
   ClusterProjector on the same jobs;
5f. runs two ranks under torchrun ([ddp] lines; NCCL when the machine has
   two cards, else gloo with both ranks on the one card, which says
   nothing about scaling): one sharded-bank step of cropnerf-mxu (K1) and
   of cropnerf (K4) at full widths on the [train] bank, 4096 rays (2048 a
   rank), held against replay_sharded_step run here on the same card
   through assert_grads_match (atol 3e-5, rtol 1e-2, camera_opt 1e-3),
   each rank's launches exact, its step time and an all-reduce of a
   buffer of the gradients' size; the replicated-bank step of
   cropnerf-mxu against the one-process step on the same draws, and the
   ranks' parameters bit for bit after 5 steps; then train --multichip
   --shard-bank on (cropnerf-mxu, 200 steps) on the [cli] dataset: one
   checkpoint that loads, run_config.json's shard_bank and padded image
   count, the RGB loss falling from step 100 to 200, each rank's K1
   launches;
5g. serves the cropnerf-mxu run with the viewer command's server
   (cli.make_viewer) in the background (its BayesRays grid, the counted
   instances and the cluster boxes): one /render per channel, each a PNG
   of the asked size, timed;
5h. trains the presets that keep ModelConfig.remat on ([remat] lines) at
   full widths and their published batches on the [train] bank:
   cropnerf-big (8192 rays), cropnerf-huge (16384) and semantic-nerf
   (4096).  For each, the gradient of one batch with remat on against
   three with it off, from the same parameters and draws: the loss equal,
   every K4 backward's positions and cotangent bit for bit, every leaf bit
   for bit where the remat-off runs agree and else within REMAT_NOISE
   times their largest deviation from one another (the grids': K4
   backward's atomics); K4's launches exactly (6 forward and 3 backward a
   step with remat on, 3 and 3 off; semantic-nerf 4 and 2, 2 and 2); step
   ms and peak memory each way, and model TFLOP/s and mfu
   (utils/flops.py) against 989 TFLOP/s; one BayesRays batch of
   cropnerf-big each way (no replay there: the same launches, the grid
   within the remat-off runs' deviation); cropnerf at 32,768 rays with
   remat on and off; K4 forward and backward at every hash encode of
   each of these steps' shapes and layouts against its plain version
   (float64 table), and its time per lookup at each hash field's table.
   Then train
   --method cropnerf-huge --max-steps 50 through the CLI on the [cli]
   scene at 600x400 (its checkpoint loads bit for bit), and the trainer's
   throughput watchdog on the card: cropnerf-big with remat off and an
   unreachable floor, 40 steps logged every 5, rebuilds at steps 10 and
   20 and "giving up" once, at step 30;
5i. drives K3's wide heads on their paths ([wide] lines): first
   cropnerf-mxu-big's training step at its published batch (8192 rays,
   512/256/128 samples; 1 + 3 steps, K1's launches exact, the first
   step's losses against the all-plain path's, step ms and peak GiB);
   then cropnerf-mxu-big
   and -huge at their published widths, random weights, a 128^3 volume
   export with colours (each head's K3 forward once a chunk) and 8
   BayesRays batches of 4096 rays on the semantics and the rgb channel
   (K3's backward once and three times a batch), with exact launch counts,
   none on the stream route; the export row for row against the same export
   with K3's plain version, the Hessians against the plain path; then
   train --method cropnerf-mxu-huge --max-steps 50, export --render-rgb at
   64 a side and uncertainty --iters 2 through the CLI on the [cli] scene
   at 600x400, K3's launches exact;
6. traces one forward, render, export and training step of cropnerf-mxu,
   one forward and training step of cropnerf, one BayesRays batch of each,
   one training step and depth-cloud batch of the fused-proposal path, one
   fused-proposal cropnerf-mxu-q training step, one [prop256] training
   step, -huge export and BayesRays batch and
   one dispatch of each project with torch.profiler, and prints the device
   time of the busiest operations and the device's busy share;
7. prints one JSON line of kernel numbers, the nvidia-smi card line, and
   the status line last.

Any failed phase raises and the script exits non-zero.  It needs a CUDA
device and the repository beside it; without either it fails before it
prints a result.  ``chip_smoke.py --rank JOB`` is the script's own rank
entry, which torchrun runs on each rank of the [ddp] and [count] phases.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOL = 1e-2               # max |kernel - plain| / max |plain|, bf16 compute
GRAD_TOL = 5e-2          # the same for gradients (f32 vs bf16 cotangents)
ROW_SHARE = 0.99         # dx, dextras: share of rows within GRAD_TOL
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth
HASH_TOL = 1e-5          # K4 forward and table gradient, of max |plain|
DPOS_TOL = 1e-4          # K4 position gradient (another summation order)
# K4 flops per (position, level), counted from csrc/hash_encode.cu: the
# cell (3 products, 3 differences); per corner, forward 5 for the weight
# and 4 for the blend, backward 5 for the weight, 2 for the scatter, 3 for
# the dot product and 9 for d(weight)/d(pos); 3 to scale the position
# gradient
HASH_FWD_FLOPS = 6 + 8 * 9
HASH_BWD_FLOPS = 6 + 8 * 19 + 3
RAYS = 4096              # the forward's ray batch (the JAX entry() batch)
RENDER_HW = 256          # full-image render, two 32,768-ray chunks
EXPORT_SIDE = 128        # volume export: 128^3 samples over the AABB
EXPORT_RAYS = 512        # rays per export chunk (sample_volume's default)
KERNEL_NS = "cropnerf::"  # the port's kernels in profiler rows
PROFILE_TRIES = 5        # profiler windows per device_ms before CUDA events
REPEATS = 5              # timed runs of each path step after its first call
TRAIN_STEPS = 20         # timed training steps after the first
UNC_LOD = 8              # BayesRays grid: (2^8+1)^3 cells (the CLI default)
UNC_BATCHES = 8          # BayesRays ray batches of RAYS rays
UNC_THRESHOLD = 0.5      # uncertainty filter of the filtered render
UNC_VIEW_SAMPLES = 1000  # the viewer's uncertainty normaliser (its default)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_clock():
    """A function that logs the wall seconds since its last call (or its
    making) under a phase's name, and the run's total so far: where the
    script's time limit goes."""
    start = time.perf_counter()
    last = [start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name}: {now - last[0]:.1f} s (total {now - start:.1f} s)")
        last[0] = now
    return lap


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back
    calls, host time the device waits through included."""
    for _ in range(warmup):
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


def device_ms(fn, iters: int, only: str | None = None) -> float:
    """Device time per call over ``iters`` calls: the kernels and copies
    torch.profiler records, those whose name contains ``only`` if given.
    Unlike ``cuda_ms`` it leaves out host time the device waited through,
    such as a wrapper packing its weights.  The profiler now and then drops
    a window's device rows, all of them or only some (a fill kernel kept,
    the port's kernel lost, or some of its launches: K6's windows keep 18
    of 20).  So with ``only`` a call's time is the recorded launches' mean
    times the launches a call makes (the recorded ones over the calls,
    rounded up); a window with no device time, or with fewer launches of
    ``only`` than half the calls, is profiled again, up to PROFILE_TRIES
    windows in all.  If every window came back short the calls are timed
    with CUDA events instead."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    what = only or "the plain version"
    for window in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (only is None or only in e.key)]
        total = sum(e.self_device_time_total for e in rows) / 1e3
        launched = sum(e.count for e in rows)
        if total > 0 and only is None:
            return total / iters
        if total > 0 and 2 * launched >= iters:
            return total / launched * math.ceil(launched / iters)
        log(f"[profile] window {window + 1} of {PROFILE_TRIES} recorded "
            f"{launched} launches and {total:.4f} ms of device time for "
            f"{what} in {iters} calls")
    log(f"[profile] no full window for {what} in {PROFILE_TRIES} windows: "
        f"timed with CUDA events instead (host time included)")
    return cuda_ms(fn, iters)


# the passes of the PE trunk's backward (csrc/fused_pe_field_bwd.cu), by
# the kernel names the profiler records
BWD_PASSES = {"tile": ("pe_field_bwd_tile_kernel",),
              "dw": ("pe_field_bwd_dw_kernel",),
              "sums": ("chunk_sum_kernel", "column_sum_kernel")}
# the PE field's forward (csrc/fused_pe_field.cu): one kernel
FWD_PASSES = {"kernel": ("pe_field_fwd_kernel",)}
# the hash-grid encode's backward (csrc/hash_encode.cu): the privatised
# levels, the other levels, the sum of the levels' dpos shares
HASH_BWD_PASSES = {"private": ("hash_private_kernel",),
                   "levels": ("hash_level_kernel",),
                   "dpos sum": ("hash_dpos_sum_kernel",)}
# the PE proposal nets' backward (csrc/fused_pe_mlp_bwd.cu) and forward
# (csrc/fused_pe_mlp_fwd.cu)
PE_MLP_BWD_PASSES = {"kernel": ("pe_mlp_bwd_kernel",),
                     "sums": ("column_sum_kernel",)}
PE_MLP_FWD_PASSES = {"kernel": ("pe_mlp_fwd_kernel",)}
# the hash-grid encode's forward (csrc/hash_encode.cu)
HASH_FWD_PASSES = {"kernel": ("hash_encode_fwd_kernel",)}
BWD_WINDOWS = 3          # profiler windows per K1/K2 timing


def pass_ms(fn, iters: int, passes: dict = BWD_PASSES,
            names: dict | None = None) -> dict:
    """Device ms per call of each pass of a kernel call (``passes``: name
    -> kernel names; the PE field's forward or backward, the hash-grid
    encode's backward, the PE nets' backward) and of all the port's
    kernels it launches ("total"), over BWD_WINDOWS profiler windows: the
    median, minimum and maximum of the windows.  A window with no device
    time for the port's kernels is profiled again, up to PROFILE_TRIES
    more windows; if none had any, "total" is timed with CUDA events and
    the passes are not measured (None).  ``names``, if given, receives
    each pass's kernel names as the profiler recorded them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per = {name: [] for name in (*passes, "total")}
    for window in range(BWD_WINDOWS + PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and KERNEL_NS in e.key]
        total = sum(e.self_device_time_total for e in events)
        if total <= 0:
            log(f"[profile] window {window + 1} recorded no device time for "
                f"{KERNEL_NS}")
            continue
        for name, keys in passes.items():
            per[name].append(sum(e.self_device_time_total for e in events
                                 if any(k in e.key for k in keys))
                             / 1e3 / iters)
            if names is not None:
                names[name] = sorted({e.key for e in events
                                      if any(k in e.key for k in keys)})
        per["total"].append(total / 1e3 / iters)
        if len(per["total"]) == BWD_WINDOWS:
            break
    if not per["total"]:
        log(f"[profile] no device time for {KERNEL_NS} in "
            f"{BWD_WINDOWS + PROFILE_TRIES} windows: total timed with CUDA "
            f"events instead (host time included), passes not measured")
        ms = cuda_ms(fn, iters)
        none = {"median": None, "min": None, "max": None}
        return {**{name: dict(none) for name in passes},
                "total": {"median": ms, "min": ms, "max": ms}}
    if len(per["total"]) < BWD_WINDOWS:
        log(f"[profile] {len(per['total'])} of {BWD_WINDOWS} windows "
            f"recorded device time for {KERNEL_NS}")
    return {name: {"median": statistics.median(v), "min": min(v),
                   "max": max(v)} for name, v in per.items()}


def cluster_report(tag: str, grid: dict, n_rows: int, halves: int,
                   img_bytes: int, passes: dict, bound_ms: float, regs: dict,
                   spills: dict, names: dict, card: str) -> dict:
    """Logs and returns what a backward tile kernel redesigned as persistent
    clusters (csrc/pe_tile.cuh) does: its cluster size and the clusters
    resident at once (the C grid query), the whole call's time against
    its bound, the kernel's registers and spills, and the kernel names the
    profiler recorded.  The log line adds the weight bytes the tile
    kernel's copies ask of L2 and their rate over the tile pass: a model
    (each group of ``cluster`` tiles takes the weight image once a 64-row
    half, ``halves`` halves a tile), not a reading, so the returned entry,
    which goes into the kernels line, leaves them out."""
    tiles = -(-n_rows // 128)
    c = max(grid["cluster"], 1)
    model_bytes = -(-tiles // c) * halves * img_bytes
    tile_ms, ms = passes["tile"]["median"], passes["total"]["median"]
    rate = ("no tile time" if not tile_ms
            else f"{model_bytes / (tile_ms * 1e9):.3f} TB/s")
    log(f"[cluster] {tag}: clusters of {grid['cluster']}, "
        f"{grid['active_clusters']} resident, {grid['blocks']} blocks for "
        f"{tiles} tiles; {ms:.4f} ms against the {bound_ms:.4f} ms bound "
        f"({ms / bound_ms:.2f}x; tile pass {tile_ms}); weight bytes asked "
        f"of L2, modelled: {model_bytes / 1e9:.3f} GB "
        f"({tiles * halves * img_bytes / 1e9:.3f} GB one block a tile), "
        f"{rate} over the tile pass; registers {regs}, spill bytes {spills}; "
        f"profiler names {names}; {card}")
    return dict(cluster=grid["cluster"],
                active_clusters=grid["active_clusters"],
                blocks=grid["blocks"], n_tiles=tiles, ms=ms, tile_ms=tile_ms,
                bound_ms=bound_ms, factor=ms / bound_ms, registers=regs,
                spill_bytes=spills, profiler_names=names)


def fwd_cluster_report(tag: str, grid: dict, n_rows: int, img_bytes: int,
                       ms: float, bound_ms: float, regs: dict, spills: dict,
                       card: str, tile_rows: int = 128) -> dict:
    """Logs and returns what a forward of the tile interpreter does with
    its weight stream: over 256 wide its column split over persistent
    clusters (csrc/pe_tile.cuh: the cluster size and the clusters resident
    at once, from the C grid query), else persistent blocks; and the
    weight bytes its copies ask of L2 in the call, modelled, not read: the
    image once a 128-row tile (a wide cluster's two blocks half of it
    each), where the wide forward before the split took it once a 64-row
    tile.  Being a model, the modelled bytes stay in the log line: the
    returned entry, which goes into the kernels line, leaves them out.
    ``tile_rows``: the rows a block takes the image for (64 in width
    class 2, both warpgroups on one tile)."""
    tiles = -(-n_rows // tile_rows)
    model = tiles * img_bytes
    wide = grid["cluster"] > 0
    how = (f"clusters of {grid['cluster']}, {grid['active_clusters']} "
           f"resident" if wide else "persistent blocks, no cluster")
    log(f"[cluster] {tag}: {how}, {grid['blocks']} blocks for {tiles} "
        f"{tile_rows}-row tiles; weight bytes asked of L2 per call, modelled: "
        f"{model / 1e9:.3f} GB ({model / (ms * 1e9):.3f} TB/s over the "
        f"call's {ms:.4f} ms"
        + (f"; {2 * model / 1e9:.3f} GB a call before the split" if wide
           else "")
        + f"); {ms:.4f} ms against the {bound_ms:.4f} ms bound "
        f"({ms / bound_ms:.2f}x); registers {regs}, spill bytes {spills}; "
        f"{card}")
    return dict(cluster=grid["cluster"],
                active_clusters=grid["active_clusters"],
                blocks=grid["blocks"], n_tiles=tiles, ms=ms, bound_ms=bound_ms,
                registers=regs, spill_bytes=spills)


def fmt_passes(p: dict) -> str:
    return ", ".join(f"{name} not measured" if v["median"] is None else
                     f"{name} {v['median']:.4f} ({v['min']:.4f}-"
                     f"{v['max']:.4f})" for name, v in p.items())


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-6)).item()


def abs_err(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def row_agreement(got, ref, tol: float = GRAD_TOL):
    """(share of rows whose largest error is within ``tol`` · max |ref|,
    relative L2 error) of a per-row gradient such as dx."""
    row_err = (got - ref).abs().amax(dim=1) / ref.abs().max().clamp_min(1e-12)
    return ((row_err <= tol).float().mean().item(),
            ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item())


def ray_share(got, ref) -> float:
    """Share of rays (rows, or pixels of an image) whose largest error is
    within 2 TOL of max |ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs().reshape(-1, g.shape[-1]).amax(1)
    return (err <= 2 * TOL * r.abs().max().clamp_min(1e-6)).float().mean().item()


def weight_grad_errors(got, ref):
    """(max error / max |ref|, relative L2) over weight and bias gradient
    pairs, the worst of each."""
    pairs = list(zip(got, ref))
    if not pairs:
        return 0.0, 0.0
    return (max(rel_err(a, b) for a, b in pairs),
            max(((a - b).norm() / b.norm().clamp_min(1e-12)).item()
                for a, b in pairs))


# [w1024]'s gradients against the bf16 plain version.  Where the two bf16
# versions round a relu unit apart (sums in another order), more rows part
# at a 1024-wide trunk than at 512: K1's semantic head's gradients measured
# up to 7.88e-2 in relative L2 and 6.35e-2 of max at 196,608 rows, K2's
# weight gradients 8.67e-2 in L2 at 128 rows, and 3 dx rows of 128 past
# GRAD_TOL (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6, [w1024]).  So
# they are held as the [w512] gradients are, to W1024_GRAD_TOL in place of
# GRAD_TOL; and each besides no further in relative L2 from the float32
# plain version than the bf16 plain version is, plus W1024_L2_MARGIN (both
# bf16 versions lie up to ~14 % from float32; the kernel measured at most
# 3.4e-3 further)
W1024_GRAD_TOL = 1e-1
W1024_L2_MARGIN = 1e-2


def as_good_as_plain(got, plain, f32, per_row: int, n: int) -> tuple:
    """(ok, each gradient's (relative L2 to the bf16 plain version, error
    of its max, relative L2 to float32, the plain version's relative L2 to
    float32)) for the kernel's gradients ``got`` against the bf16 plain
    version's ``plain`` and the float32 plain version's ``f32``: the first
    ``per_row`` (dx, dextras) to ROW_SHARE of rows and in relative L2
    within W1024_GRAD_TOL of ``plain``, the others as weight_grads_ok at
    W1024_GRAD_TOL, each no further from ``f32`` than ``plain`` is, plus
    W1024_L2_MARGIN."""
    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()
    leaves = [(rel(a, p), rel_err(a, p), rel(a, f), rel(p, f))
              for a, p, f in zip(got, plain, f32)]
    rows = [row_agreement(a, p, W1024_GRAD_TOL)
            for a, p in zip(got[:per_row], plain[:per_row])]
    ok = (all(share >= ROW_SHARE and l2 <= W1024_GRAD_TOL
              for share, l2 in rows)
          and all(weight_grads_ok(err, l2, n, W1024_GRAD_TOL)
                  for l2, err, _, _ in leaves[per_row:])
          and all(to_f32 <= plain_f32 + W1024_L2_MARGIN
                  for _, _, to_f32, plain_f32 in leaves))
    return ok, leaves


def weight_grads_ok(w_err, w_l2, n, tol: float = GRAD_TOL) -> bool:
    """Weight and bias gradients within ``tol`` in relative L2, and within
    ``tol`` of max |plain| over 1000 rows or more: a relu unit that flips
    in one row moves that row's outer product by up to ~10 % of the largest
    entry when the sum runs over a single 128-row tile."""
    return w_l2 <= tol and (n < 1000 or w_err <= tol)


def ptxas_registers(report: str) -> dict:
    """Registers per kernel entry in an ``nvcc -Xptxas -v`` report."""
    regs, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry is not None:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
    return regs


def ptxas_spills(report: str) -> dict:
    """Spill bytes (stores + loads) per function (kernel entries and
    device functions not inlined) in an ``nvcc -Xptxas -v`` report."""
    spills, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and name is not None:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills[name] = nums[1] + nums[2]
            name = None
    return spills


def bool_args(name: str) -> str:
    """The bool and int template arguments of a mangled kernel name, as
    "<true, false>" or "<true, 2>" (the backwards' STORE, the stream
    kernels' WIDE, the PE field's tile kernels' width class); "" for
    none."""
    m = re.search(r"_kernelI((?:L[bi]\d+E)+)E", name)
    if not m:
        return ""
    args = re.findall(r"L([bi])(\d+)E", m.group(1))
    return "<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v
                           for t, v in args) + ">"


def bool_word(b: bool) -> str:
    return "true" if b else "false"


def short_names(per_entry: dict) -> dict:
    """Mangled kernel names of the PE field's kernels -> readable ones (with
    their bool template arguments); others as they are."""
    out = {}
    for name, v in per_entry.items():
        short = name
        for kernel in ("pe_field_bwd_tile_kernel", "pe_field_bwd_dw_kernel",
                       "chunk_sum_kernel", "column_sum_kernel", "dx_rows",
                       "pe_field_fwd_kernel"):
            if kernel in name:
                short = kernel + bool_args(name)
        out[short] = v
    return out


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- the hash-grid family (cropnerf) ---------------------------------------

def hash_path_shapes(cfg):
    """(label, positions, grid config) of the three encodes of one cropnerf
    training step: the field and the two proposal nets."""
    m, rays = cfg.model, cfg.train_num_rays_per_batch
    return [("field", rays * m.num_nerf_samples_per_ray, m.field.grid),
            ("proposal 0", rays * m.num_proposal_samples_per_ray[0],
             m.proposal_fields[0].grid),
            ("proposal 1", rays * m.num_proposal_samples_per_ray[1],
             m.proposal_fields[1].grid)]


def corner_rows(pos, layout):
    """Per level, the table rows [N, 8] of the 8 corners these positions
    read, in corner order, as csrc/hash_encode.cu indexes them."""
    from cropnerf_tpu_torch.ops.hashgrid import _hash3
    res, offsets, dense, t = layout
    for r, off, d in zip(res, offsets, dense):
        base = torch.floor(pos * r).long()
        if d:
            base = base.clamp(0, r - 1)
        rows = []
        for corner in range(8):
            c = base + torch.tensor([corner & 1, (corner >> 1) & 1,
                                     (corner >> 2) & 1], device=pos.device)
            idx = ((c[:, 0] * (r + 1) + c[:, 1]) * (r + 1) + c[:, 2] if d
                   else _hash3(c[:, 0], c[:, 1], c[:, 2], t))
            rows.append(off + idx)
        yield torch.stack(rows, 1)


def rows_touched(pos, layout) -> int:
    """Table rows that these positions read: the corners of their cells at
    every level, each counted once (the data-dependent part of K4's
    bytes)."""
    return int(torch.unique(torch.cat([torch.unique(rows) for rows in
                                       corner_rows(pos, layout)])).numel())


def lookup_sectors(pos, layout) -> int:
    """The distinct 32-byte sectors of the table that the 8 corner gathers
    of each (position, level) touch, summed over the positions and levels
    (a sector holds 4 aligned 8-byte rows; the table starts 32-byte
    aligned): K4 forward's gathers at one sector per distinct sector."""
    total = 0
    for rows in corner_rows(pos, layout):
        sec = torch.sort(rows >> 2, dim=1).values
        total += int(sec.shape[0] + (sec[:, 1:] != sec[:, :-1]).sum())
    return total


def gather_rate(table2d, n: int = 1 << 24) -> float:
    """The card's rate of random 8-byte row gathers, sectors a second: a
    PyTorch index_select of n uniform random rows of ``table2d`` seen as
    one float64 a row (a thread a row, each gather a sector of its own;
    the int32 indices and the output streamed besides), timed over one
    profiler window."""
    g = torch.Generator(device=table2d.device).manual_seed(17)
    idx = torch.randint(0, table2d.shape[0], (n,), generator=g,
                        device=table2d.device, dtype=torch.int32)
    rows = table2d.view(torch.float64).reshape(-1)
    return n / (device_ms(lambda: rows.index_select(0, idx), 10) * 1e-3)


def hash_kernels(cfg, dev, card, report: str) -> dict:
    """K4 forward and backward against the plain version at the path's
    shapes, a ragged N and a small dense [L, T, F] table: errors, and at
    the path's shapes times and bounds.  Returns the two kernels' entries
    of the JSON line, each summed over one training step's three
    encodes."""
    from cropnerf_tpu_torch.ops import hashgrid as hg
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    g = torch.Generator(device=dev).manual_seed(5)
    path = hash_path_shapes(cfg)
    field_grid = path[0][2]
    cases = path + [
        ("field, ragged N", path[0][1] - 77, field_grid),
        ("small dense [L,T,F] table", 1000,
         dataclasses.replace(field_grid, num_levels=4, log2_hashmap_size=12,
                             min_res=4, max_res=32, layout="dense"))]
    per, rate = {}, None
    for label, n, gc in cases:
        res = hg.level_resolutions(gc.num_levels, gc.min_res, gc.max_res)
        t = 2 ** gc.log2_hashmap_size
        shape = ((sum(hg.level_row_counts(res, t)), gc.features_per_level)
                 if gc.layout == "packed"
                 else (gc.num_levels, t, gc.features_per_level))
        table = torch.rand(shape, generator=g, device=dev) * 2 - 1
        pos = torch.rand((n, 3), generator=g, device=dev)
        pos[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                                [1.0, 0.0, 0.5]], device=dev)
        table2d, offsets, dense, _ = hg._table_layout(table, res, "auto", t)
        layout = (tuple(res), tuple(offsets), tuple(dense), t)
        cot = torch.randn((n, 2 * len(res)), generator=g, device=dev)

        def kf():
            return kh.hash_encode_fwd(table2d, pos, *layout)

        def pf():
            return hg.hashgrid_encode_plain(table, pos, res, table_size=t)

        def kb():
            return kh.hash_encode_bwd(table2d, pos, cot, *layout)

        def pb():
            tt = table.clone().requires_grad_(True)
            tp = pos.clone().requires_grad_(True)
            with torch.enable_grad():
                hg.hashgrid_encode_plain(tt, tp, res,
                                         table_size=t).backward(cot)
            return tt.grad.reshape(-1, 2), tp.grad

        with torch.no_grad():
            out, ref = kf(), pf()
        (dt, dp), (dt_ref, dp_ref) = kb(), pb()
        k = dict(n=n, levels=len(res), rows=table2d.shape[0],
                 dense_levels=sum(dense), layout=gc.layout,
                 group=kh.level_group(len(res)),
                 fwd_err=rel_err(out, ref), fwd_abs=abs_err(out, ref),
                 fwd_bitwise=bool(torch.equal(out, ref)),
                 dtable_err=rel_err(dt, dt_ref), dtable_abs=abs_err(dt, dt_ref),
                 dpos_err=rel_err(dp, dp_ref), dpos_abs=abs_err(dp, dp_ref))
        log(f"[kernel] hash_encode {label}: positions [{n},3], {k['levels']} "
            f"levels, {k['layout']} table of {k['rows']} rows "
            f"({k['dense_levels']} dense levels); err forward "
            f"{k['fwd_err']:.2e} (bit-identical {k['fwd_bitwise']}), dtable "
            f"{k['dtable_err']:.2e}, dpos {k['dpos_err']:.2e} (limits "
            f"{HASH_TOL}, {HASH_TOL}, {DPOS_TOL})")
        check(k["fwd_bitwise"] and k["dtable_err"] <= HASH_TOL
              and k["dpos_err"] <= DPOS_TOL,
              f"hash_encode {label} disagrees with its plain version")
        if (label, n, gc) in path:
            touched = rows_touched(pos, layout)
            if rate is None:                 # on the field's table
                rate = gather_rate(table2d)
            k.update(touched=touched, sectors=lookup_sectors(pos, layout),
                     fwd_passes=pass_ms(kf, 20, HASH_FWD_PASSES),
                     call_ms=cuda_ms(kf, 20),
                     plain_ms=device_ms(pf, 3),
                     bwd_passes=pass_ms(kb, 10, HASH_BWD_PASSES),
                     bwd_call_ms=cuda_ms(kb, 10), bwd_plain_ms=device_ms(pb, 3))
            k["ms"] = k["fwd_passes"]["total"]["median"]
            k["bwd_ms"] = k["bwd_passes"]["total"]["median"]
            k["sectors_at_index_select_rate_ms"] = k["sectors"] / rate * 1e3
            # each input read once (of the table, the rows these positions
            # touch), each output written once (the whole table gradient)
            fwd_bytes = nbytes(pos, out) + touched * 8
            bwd_bytes = nbytes(pos, cot, dt, dp) + touched * 8
            k.update(
                bound_ms=max(fwd_bytes / PEAK_BYTES, n * len(res)
                             * HASH_FWD_FLOPS / PEAK_F32_FLOPS) * 1e3,
                bwd_bound_ms=max(bwd_bytes / PEAK_BYTES, n * len(res)
                                 * HASH_BWD_FLOPS / PEAK_F32_FLOPS) * 1e3,
                whole_table_bound_ms=nbytes(pos, out, table2d)
                / PEAK_BYTES * 1e3)
            log(f"[kernel] hash_encode {label}: forward {k['ms']:.4f} ms "
                f"(call {k['call_ms']:.4f}; {k['group']} levels a thread; "
                f"over {BWD_WINDOWS} windows, median (min-max): "
                f"{fmt_passes(k['fwd_passes'])}), plain {k['plain_ms']:.4f} "
                f"ms, bound {k['bound_ms']:.4f} ms (bytes; {touched} of "
                f"{k['rows']} rows read; with the whole table read "
                f"{k['whole_table_bound_ms']:.4f} ms); gathers "
                f"{k['sectors'] / (n * len(res)):.3f} distinct 32-byte "
                f"sectors a (position, level), {k['sectors']} in all: "
                f"{k['sectors_at_index_select_rate_ms']:.4f} ms at "
                f"index_select's gather rate {rate:.4e} sectors/s; backward "
                f"{k['bwd_ms']:.4f} ms (call with the zeroed gradient "
                f"{k['bwd_call_ms']:.4f}; by pass over {BWD_WINDOWS} windows, "
                f"median (min-max): {fmt_passes(k['bwd_passes'])}), plain "
                f"{k['bwd_plain_ms']:.4f} ms, bound {k['bwd_bound_ms']:.4f} ms "
                f"(bytes); {card}")
        per[label] = k
        del table, table2d, pos, cot, out, ref, dt, dp, dt_ref, dp_ref
    spills = [line.strip() for line in report.splitlines() if "spill" in line]
    log(f"[build] hash_encode registers {ptxas_registers(report)}; "
        + "; ".join(spills))
    timed = [per[p[0]] for p in path]
    shape = ", ".join(f"{p[0]} [{p[1]},3] x {per[p[0]]['levels']} levels "
                      f"({per[p[0]]['rows']} rows)" for p in path)
    common = dict(source="cropnerf_tpu_torch/csrc/hash_encode.cu",
                  bound_by="bytes", by_shape=per)
    return {
        "hash_encode": dict(
            common, replaces="cropnerf_tpu/ops/pallas/hash_encode.py:35",
            shape=f"one cropnerf train step's three encodes: {shape}",
            ms=sum(k["ms"] for k in timed),
            ms_min=sum(k["fwd_passes"]["total"]["min"] for k in timed),
            ms_max=sum(k["fwd_passes"]["total"]["max"] for k in timed),
            gather_rate=rate,
            sectors_at_index_select_rate_ms=sum(k["sectors_at_index_select_rate_ms"] for k in timed),
            fwd_bitwise=all(k["fwd_bitwise"] for k in per.values()),
            call_ms=sum(k["call_ms"] for k in timed),
            plain_ms=sum(k["plain_ms"] for k in timed),
            bound_ms=sum(k["bound_ms"] for k in timed),
            rel_err=max(k["fwd_err"] for k in per.values()),
            max_abs_err=max(k["fwd_abs"] for k in per.values())),
        "hash_encode_bwd": dict(
            common, replaces="cropnerf_tpu/ops/pallas/hash_encode.py:131",
            shape=f"the backward of the same three encodes: {shape}",
            ms=sum(k["bwd_ms"] for k in timed),
            call_ms=sum(k["bwd_call_ms"] for k in timed),
            plain_ms=sum(k["bwd_plain_ms"] for k in timed),
            bound_ms=sum(k["bwd_bound_ms"] for k in timed),
            rel_err=max(max(k["dtable_err"], k["dpos_err"])
                        for k in per.values()),
            max_abs_err=max(max(k["dtable_abs"], k["dpos_abs"])
                            for k in per.values()))}


def plain_grids(cfg):
    """``cfg`` with every hash grid on the plain PyTorch encode."""
    def plain(g):
        return dataclasses.replace(g, impl="plain")
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, grid=plain(m.field.grid)),
        proposal_fields=tuple(dataclasses.replace(p, grid=plain(p.grid))
                              for p in m.proposal_fields)))


def counted(kernels, fn) -> dict:
    """Launches of each kernel during ``fn()``: every count is set to 0
    just before and read just after."""
    for k in kernels:
        k.launches = 0
    fn()
    return {k.__name__: k.launches for k in kernels}


def export_thresholds(params, fcfg, g, dev) -> dict:
    """The reference thresholds (density 70, logit 3, sigmoid 0.9) keep no
    sample of a field with random weights; take them from the field's own
    quantiles over the box, so that every cloud holds points."""
    from cropnerf_tpu_torch.models.field import field_density, field_semantics
    with torch.no_grad():
        pts = torch.rand((65536, 3), generator=g, device=dev) * 2 - 1
        dens, geo = field_density(params.field, pts, fcfg)
        logit = field_semantics(params.field, geo, fcfg)[:, 0]
    return dict(density_threshold=dens.quantile(0.75).item(),
                semantic_threshold=logit.quantile(0.5).item(),
                colormap_threshold=torch.sigmoid(logit.quantile(0.25)).item())


def hash_serving(dev, card, rb, cams, aabb, out_dir, kernels):
    """cropnerf serving at full published widths (field grid 16 x 2^19,
    proposal grids 5 x 2^17, 256/96/48 samples): forward, render and
    export, each with exact launch counts, timed, then against the plain
    path.  The grids are drawn in ±0.5 (the ±1e-4 init gives a nearly
    constant field).  Returns (numbers for the JSON line, the forward call
    for the trace)."""
    from cropnerf_tpu_torch.export.ply import ply_vertex_count
    from cropnerf_tpu_torch.export.volume import export_and_write
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import forward, model_init
    from cropnerf_tpu_torch.train.step import make_render_fn
    cfg = PRESETS["cropnerf"]
    m = cfg.model
    params = model_init(m, num_images=8,
                        generator=torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("grid"):
                p.uniform_(-0.5, 0.5, generator=g)
    thresholds = export_thresholds(params, m.field, g, dev)
    log(f"[path] cropnerf export thresholds {thresholds}")
    n_px = RENDER_HW * RENDER_HW
    per_pass = 1 + m.num_proposal_iterations
    expected = {"forward": per_pass,
                "render": math.ceil(n_px / cfg.eval_num_rays_per_chunk) * per_pass,
                "export": math.ceil(EXPORT_SIDE ** 2 / EXPORT_RAYS)}
    render = make_render_fn(cfg)
    result = {}
    steps = {
        "forward": lambda: result.update(fwd=forward(params, rb, m)),
        "render": lambda: result.update(
            img=render(params, cams, 0, RENDER_HW, RENDER_HW)),
        "export": lambda: result.update(paths=export_and_write(
            params, m, aabb, out_dir / "cropnerf",
            num_points_per_side=EXPORT_SIDE, rays_per_batch=EXPORT_RAYS,
            render_rgb=True, **thresholds))}
    launches, first_ms = {}, {}
    for step, fn in steps.items():
        first_ms[step] = wall_ms(
            lambda: launches.update({step: counted(kernels, fn)}))
        want = {k.__name__: 0 for k in kernels}
        want["hash_encode"] = expected[step]
        log(f"[path] cropnerf {step} launches: {launches[step]}")
        check(launches[step] == want, f"cropnerf {step} launches "
              f"{launches[step]}, expected {want}")
    runs_ms = {step: [wall_ms(fn) for _ in range(REPEATS)]
               for step, fn in steps.items()}
    med_ms = {step: statistics.median(v) for step, v in runs_ms.items()}
    counts = {k: ply_vertex_count(p) for k, p in result["paths"].items()}
    for step, what, n_rays in (
            ("forward", f"{RAYS} rays", RAYS),
            ("render", f"{RENDER_HW}x{RENDER_HW}", n_px),
            ("export", f"{EXPORT_SIDE}^3 with colours, points {counts}",
             None)):
        rate = (f" ({n_rays / med_ms[step] * 1e3:.0f} rays/s)"
                if n_rays else "")
        log(f"[path] cropnerf {step} {what}: median {med_ms[step]:.2f} ms of "
            f"{REPEATS}{rate}, runs "
            + ", ".join(f"{v:.2f}" for v in runs_ms[step])
            + f" ms; first call {first_ms[step]:.2f} ms; {card}")

    fwd, img = result["fwd"], result["img"]
    for k in ("rgb", "accumulation", "depth", "semantics"):
        check(bool(torch.isfinite(fwd[k]).all()) and fwd[k].shape[0] == RAYS,
              f"cropnerf forward {k}")
        check(bool(torch.isfinite(img[k]).all())
              and img[k].shape[:2] == (RENDER_HW, RENDER_HW),
              f"cropnerf render {k}")
    plain = plain_grids(cfg)
    fwd_p = forward(params, rb, plain.model)
    img_p = make_render_fn(plain)(params, cams, 0, RENDER_HW, RENDER_HW)
    agree = {}
    for label, a, b in (("forward", fwd, fwd_p), ("render", img, img_p)):
        for k in ("rgb", "accumulation", "semantics", "depth"):
            agree[f"{label} {k}"] = rel_err(a[k], b[k])
    paths_p = export_and_write(params, plain.model, aabb,
                               out_dir / "cropnerf-plain",
                               num_points_per_side=EXPORT_SIDE,
                               rays_per_batch=EXPORT_RAYS, render_rgb=True,
                               **thresholds)
    counts_p = {k: ply_vertex_count(p) for k, p in paths_p.items()}
    log("[check] cropnerf kernel path vs plain path: "
        + ", ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; export points {counts} vs plain {counts_p}")
    for k, v in agree.items():
        check(v <= 2 * TOL, f"cropnerf {k}: {v:.3e} > {2 * TOL}")
    check(counts["density"] > counts["semantic"] > 0, f"export {counts}")
    for k in counts:
        check(abs(counts[k] - counts_p[k]) <= 0.01 * counts_p[k] + 10,
              f"cropnerf export {k}: {counts[k]} points vs plain {counts_p[k]}")
    info = {"card": card, "repeats": REPEATS, "median_ms": med_ms,
            "runs_ms": runs_ms, "first_ms": first_ms,
            "forward_rays_per_s": RAYS / med_ms["forward"] * 1e3,
            "render_rays_per_s": n_px / med_ms["render"] * 1e3,
            "export_points": counts, "launches": launches,
            "vs_plain": agree}
    return info, steps["forward"]


def hash_training(dev, card, bank, kernels, rate):
    """cropnerf training at 4096 rays on the resident bank: one step on the
    kernel path against the plain path, a first step and TRAIN_STEPS timed
    steps (all proposal-update steps: 3 forward and 3 backward encodes
    each), then one step between proposal updates (3 forward, 1 backward)
    and the peak memory of an update step; K4 on one step's own inputs
    (``hash_real_step``, sectors timed at index_select's gather rate
    ``rate``).  Returns (numbers for the JSON line, the step call for the trace)."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import (_prop_update_bool,
                                               make_eval_batch_fn,
                                               make_train_step, train_loss)
    cfg = PRESETS["cropnerf"]
    R = cfg.train_num_rays_per_batch
    n_img = bank.num_images
    one = {}
    for label, c in (("kernel", cfg), ("plain", plain_grids(cfg))):
        st = create_train_state(c, n_img, torch.Generator().manual_seed(0), dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        idx = torch.randint(0, bank.num_pixels, (R,), generator=gen,
                            device=dev)
        loss, _ = train_loss(st.params, bank, idx, 0, c, gen)
        loss.backward()
        one[label] = (loss.item(), {k: p.grad.clone() for k, p in
                                    st.params.named_parameters()})
        del st
    (l_k, g_k), (l_p, g_p) = one["kernel"], one["plain"]
    leaf_err = {k: rel_err(g_k[k], g_p[k]) for k in g_p}
    worst = max(leaf_err, key=leaf_err.get)
    log(f"[train] cropnerf one step, kernel path vs plain path: loss "
        f"{l_k:.6f} vs {l_p:.6f} (rel {abs(l_k - l_p) / abs(l_p):.2e}); "
        f"gradient leaves within {GRAD_TOL} of max: "
        f"{sum(v <= GRAD_TOL for v in leaf_err.values())}/{len(leaf_err)}, "
        f"worst {worst} {leaf_err[worst]:.2e}")
    check(math.isfinite(l_k) and abs(l_k - l_p) <= 2e-2 * abs(l_p),
          f"cropnerf train loss {l_k} vs plain {l_p}")
    for k, v in leaf_err.items():
        check(bool(torch.isfinite(g_k[k]).all()) and v <= GRAD_TOL,
              f"cropnerf train gradient {k}: {v:.3e}")
    del one, g_k, g_p
    real_step = hash_real_step(bank, dev, rate)

    state = create_train_state(cfg, n_img, torch.Generator().manual_seed(0),
                               dev)
    train_step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    metrics = {}

    def run_train():
        metrics.update(train_step(state, bank, gen)[1])

    runs = []
    n_steps = 1 + TRAIN_STEPS
    launches = counted(kernels, lambda: runs.extend(
        wall_ms(run_train) for _ in range(n_steps)))
    first_ms, runs_ms = runs[0], runs[1:]
    log(f"[train] cropnerf launches on the training path ({n_steps} "
        f"steps): {launches}")
    want = {k.__name__: 0 for k in kernels}
    want.update(hash_encode=3 * n_steps, hash_encode_bwd=3 * n_steps)
    check(launches == want, f"cropnerf training launches {launches}, "
          f"expected {want}")
    loss_now = metrics["loss"].item()
    changed = sum(not torch.equal(v, before[k])
                  for k, v in state.params.state_dict().items())
    check(math.isfinite(loss_now) and state.step == n_steps,
          f"cropnerf training loss {loss_now}, step {state.step}")
    check(changed == len(before),
          f"{len(before) - changed} cropnerf parameter tensors did not change")

    # one step between proposal updates: no proposal backward
    state.step = 5001
    check(not bool(_prop_update_bool(state.step, cfg)), "5001 updates")
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    frozen_launches = counted(kernels, run_train)
    want.update(hash_encode=3, hash_encode_bwd=1)
    log(f"[train] cropnerf launches of one step between proposal updates "
        f"(step 5001): {frozen_launches}")
    check(frozen_launches == want, f"cropnerf step 5001 launches "
          f"{frozen_launches}, expected {want}")
    moved = {k: not torch.equal(v, before[k])
             for k, v in state.params.state_dict().items()}
    check(all(v != k.startswith("proposal_") for k, v in moved.items()),
          f"step 5001 moved {moved}")

    med = statistics.median(runs_ms)
    # back to the timed steps' schedule, where every step updates the
    # proposal nets, for the peak memory and the trace
    state.step = n_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    eval_m = {k: v.item() for k, v in make_eval_batch_fn(cfg)(
        state.params, bank, gen).items()}
    check(all(math.isfinite(v) for v in eval_m.values()), f"eval {eval_m}")
    log(f"[train] cropnerf step: median {med:.2f} ms of {TRAIN_STEPS} "
        f"({R / med * 1e3:.0f} rays/s), runs "
        + ", ".join(f"{v:.2f}" for v in runs_ms)
        + f" ms; first step {first_ms:.2f} ms; peak device memory "
        f"{peak:.2f} GiB; loss {loss_now:.5f}, psnr "
        f"{metrics['psnr'].item():.3f}; eval batch {eval_m}; {card}")
    info = {"card": card, "rays": R, "steps": TRAIN_STEPS, "median_ms": med,
            "runs_ms": runs_ms, "first_ms": first_ms, "peak_gib": peak,
            "rays_per_s": R / med * 1e3, "loss": loss_now,
            "launches": launches, "no_update_step_launches": frozen_launches,
            "vs_plain_loss_rel": abs(l_k - l_p) / abs(l_p),
            "vs_plain_grad_worst": [worst, leaf_err[worst]],
            "hash_encode_real_step": real_step}
    return info, run_train


def hash_real_step(bank, dev, rate) -> dict:
    """K4 on the inputs of one cropnerf training step
    (tools/hash_bwd_real_step.py captures them): the forward of each of
    the step's three encodes bit for bit against its plain version, with
    its sectors (their time at index_select's gather rate ``rate``); the
    backward of each against its plain version with a float64 table; the
    device time of the three calls of each."""
    from cropnerf_tpu_torch.ops import hashgrid as hg
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    from tools.hash_bwd_real_step import step_inputs
    captured = step_inputs(bank, dev)
    check(len(captured["fwd"]) == 3 and len(captured["bwd"]) == 3,
          f"{len(captured['fwd'])} hash_encode and {len(captured['bwd'])} "
          "hash_encode_bwd calls in a cropnerf training step, expected 3 each")
    fwd_calls = []
    for table2d, pos, layout in captured["fwd"]:
        res, offsets, dense, t = layout
        with torch.no_grad():
            out = kh.hash_encode_fwd(table2d, pos, *layout)
            ref = hg.hashgrid_encode_plain(table2d, pos, res, table_size=t)
        sectors = lookup_sectors(pos, layout)
        c = dict(n=pos.shape[0], levels=len(res),
                 bitwise=bool(torch.equal(out, ref)), sectors=sectors,
                 sectors_per_lookup=sectors / (pos.shape[0] * len(res)),
                 sectors_at_index_select_rate_ms=sectors / rate * 1e3,
                 passes=pass_ms(lambda: kh.hash_encode_fwd(table2d, pos,
                                                           *layout), 20,
                                HASH_FWD_PASSES))
        c["ms"] = c["passes"]["total"]["median"]
        check(c["bitwise"], f"hash_encode on a training step's inputs "
              f"differs from its plain version: {c}")
        fwd_calls.append(c)
        del out, ref
    calls = []
    for table2d, pos, cot, layout in captured["bwd"]:
        res, offsets, dense, t = layout
        dt, dp = kh.hash_encode_bwd(table2d, pos, cot, *layout)
        tt = table2d.double().requires_grad_(True)
        tp = pos.clone().requires_grad_(True)
        with torch.enable_grad():
            hg.hashgrid_encode_plain(tt, tp, res, table_size=t).backward(
                cot.double())
        c = dict(n=pos.shape[0], levels=len(res),
                 dtable_err=rel_err(dt, tt.grad), dpos_err=rel_err(dp, tp.grad),
                 passes=pass_ms(lambda: kh.hash_encode_bwd(table2d, pos, cot,
                                                           *layout), 10,
                                HASH_BWD_PASSES))
        c["ms"] = c["passes"]["total"]["median"]
        check(c["dtable_err"] <= HASH_TOL and c["dpos_err"] <= DPOS_TOL,
              f"hash_encode_bwd on a training step's inputs: {c}")
        calls.append(c)
        del tt, tp, dt, dp

    def total(cs):
        return {"calls": cs, "ms": sum(c["ms"] for c in cs),
                "ms_min": sum(c["passes"]["total"]["min"] for c in cs),
                "ms_max": sum(c["passes"]["total"]["max"] for c in cs)}

    fwd = total(fwd_calls)
    fwd["sectors_at_index_select_rate_ms"] = sum(c["sectors_at_index_select_rate_ms"] for c in fwd_calls)
    return {"fwd": fwd, "bwd": total(calls)}


# ---- the BayesRays slice: K2 and K3 backward, the [uncertainty] phase ------

def density_bwd_entry(base, top, trunk_macs, n, dev, card, report,
                      names: dict | None = None,
                      vs_f32: bool = False) -> dict:
    """K2 backward (the trunk-only mode of csrc/fused_pe_field_bwd.cu)
    against autograd through the plain version at N = 128, 1000, n - 77 and
    n, with the weight gradients and with dx alone (the BayesRays pass's
    variant, which the entry's ms and bound are for); with ``vs_f32`` (a
    1024-wide trunk) held as as_good_as_plain holds gradients."""
    from cropnerf_tpu_torch.models.vanilla import POS_FREQS
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    g = torch.Generator(device=dev).manual_seed(11)
    wd = [w.detach() for w in (*base, *top)]
    nb = len(base)
    x_all = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
    cot_all = torch.randn((n, top[-2].shape[1]), generator=g, device=dev)

    def plain(xb, cot, need_dw, dtype=torch.bfloat16):
        leaves = [xb.clone().requires_grad_(True)] + [
            w.clone().requires_grad_(need_dw) for w in wd]
        with torch.enable_grad():
            out = kf.fused_pe_density_plain(leaves[0], leaves[1:nb + 1],
                                            leaves[nb + 1:], POS_FREQS,
                                            dtype)
            ask = leaves if need_dw else leaves[:1]
            return list(torch.autograd.grad(out, ask, cot))

    def kernel(xb, cot, need_dw):
        dx, db_, dt_ = kf.fused_pe_density_bwd(xb, wd[:nb], wd[nb:],
                                               POS_FREQS, cot, True,
                                               need_dw)
        return [dx] + (list(db_) + list(dt_) if need_dw else [])

    cases = {}
    for m in (128, 1000, n - 77, n):
        xb, cot = x_all[:m].contiguous(), cot_all[:m].contiguous()
        for need_dw in (False, True):
            got, ref = kernel(xb, cot, need_dw), plain(xb, cot, need_dw)
            share, l2 = row_agreement(got[0], ref[0])
            w_err, w_l2 = weight_grad_errors(got[1:], ref[1:])
            cases[(m, need_dw)] = dict(
                rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
                abs=max(abs_err(a, b) for a, b in zip(got, ref)))
            if vs_f32:
                ok, leaves = as_good_as_plain(
                    got, ref, plain(xb, cot, need_dw, torch.float32), 1, m)
                cases[(m, need_dw)]["leaves"] = leaves
            else:
                ok = (share >= ROW_SHARE and l2 <= GRAD_TOL
                      and weight_grads_ok(w_err, w_l2, m))
            check(ok, f"fused_pe_density_bwd N={m} dW={need_dw}: rows "
                  f"{share:.4f}, dx L2 {l2:.2e}, weights {w_err:.2e} (L2 "
                  f"{w_l2:.2e}); {cases[(m, need_dw)]}")
            if m == n:
                again = kernel(xb, cot, need_dw)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      "fused_pe_density_bwd differs between two runs")
                if need_dw:
                    check(torch.equal(got[0], dx_only),
                          "dx-only K2 backward differs from the full one")
                else:
                    dx_only = got[0]
            del got, ref
    xb, cot = x_all, cot_all
    k = dict(
        shape=f"x [{n},3], g [{n},16] -> dx (BayesRays: no weight gradient)",
        source="cropnerf_tpu_torch/csrc/fused_pe_field_bwd.cu",
        replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:151",
        cases={f"N={m}{' with dW' if w else ' dx only'}": v
               for (m, w), v in cases.items()},
        max_abs_err=cases[(n, False)]["abs"],
        rel_err=cases[(n, False)]["dx_l2"],
        passes=pass_ms(lambda: kernel(xb, cot, False), 10, BWD_PASSES, names),
        call_ms=cuda_ms(lambda: kernel(xb, cot, False), 10),
        plain_ms=device_ms(lambda: plain(xb, cot, False), 3),
        with_dw_passes=pass_ms(lambda: kernel(xb, cot, True), 5),
        with_dw_plain_ms=device_ms(lambda: plain(xb, cot, True), 3),
        # recompute and input gradients (dx only); the weight gradient adds
        # a third product
        flops=2.0 * n * trunk_macs * 2,
        bytes=nbytes(xb, cot, xb, *wd))
    k["ms"] = k["passes"]["total"]["median"]
    k["with_dw_ms"] = k["with_dw_passes"]["total"]["median"]
    k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
    k["with_dw_bound_ms"] = bound(3.0 * n * trunk_macs * 2,
                                  nbytes(xb, cot, xb, *wd) + nbytes(*wd))[0]
    k["registers"] = short_names(ptxas_registers(report))
    k["spill_bytes"] = short_names(ptxas_spills(report))
    log(f"[kernel] fused_pe_density_bwd: {k['shape']}; dx rows within "
        f"{GRAD_TOL} of max and L2 by case: "
        + ", ".join(f"{c}: {v['rows']:.5f}/{v['dx_l2']:.2e} (weights "
                    f"{v['w_err']:.2e})" for c, v in k["cases"].items())
        + f"; dx only {k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}); with dW {k['with_dw_ms']:.4f} ms, plain "
        f"{k['with_dw_plain_ms']:.4f} ms, bound {k['with_dw_bound_ms']:.4f} "
        f"ms; {card}")
    log(f"[kernel] fused_pe_density_bwd: device ms per pass over "
        f"{BWD_WINDOWS} windows, median (min-max): dx only "
        f"{fmt_passes(k['passes'])}; with dW {fmt_passes(k['with_dw_passes'])}"
        f"; registers {k['registers']}, spill bytes {k['spill_bytes']}; {card}")
    return k


def kernel_names(per_entry: dict, keep: str) -> dict:
    """Mangled names of the kernel entries whose name holds ``keep`` ->
    name<args> (ints as numbers, bools as true/false); others dropped."""
    out = {}
    for name, v in per_entry.items():
        m = re.search(r"([A-Za-z_]+_kernel)I((?:L[ib]\d+E)+)E", name)
        if keep in name and m:
            args = [a if t == "i" else ("true" if a == "1" else "false")
                    for t, a in re.findall(r"L([ib])(\d+)E", m.group(2))]
            out[f"{m.group(1)}<{', '.join(args)}>"] = v
    return out


def k3_names(per_entry: dict, keep: str, pe: bool = False) -> dict:
    """``kernel_names`` of csrc/fused_mlp_fwd.cu's or fused_mlp_bwd.cu's
    entries: K3's (the PE template argument, the last, false) or, with
    ``pe``, K5's wide route's (true)."""
    end = "true>" if pe else "false>"
    return {k: v for k, v in kernel_names(per_entry, keep).items()
            if k.endswith(end)}


def k3_counts(fn) -> dict:
    """Launches of K3's four counters during ``fn()``."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    return counted((km.fused_mlp, km.fused_mlp_stream, km.fused_mlp_bwd,
                    km.fused_mlp_stream_bwd), fn)


def mlp_fwd_entry(heads, n, dev, card, report) -> dict:
    """K3 forward (csrc/fused_mlp_fwd.cu, the wgmma route) on the vanilla
    field's two heads at one export chunk (N = n) against the plain
    version: at n, a ragged N, the tiles' edges (N = 1, 63, 64, 65) and an
    x one row into a larger tensor (not 16-byte aligned, the same bits as
    an aligned copy); two runs bit-identical; each call's launches on the
    wgmma counter alone.  The entry's ms, plain ms and bound are the two
    heads' summed (the export launches each head once a chunk)."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    g = torch.Generator(device=dev).manual_seed(14)
    per = {}
    want = {"fused_mlp": 1, "fused_mlp_stream": 0, "fused_mlp_bwd": 0,
            "fused_mlp_stream_bwd": 0}
    for label, wbs in heads.items():
        wd = [w.detach() for w in wbs]
        dims = [wd[0].shape[0]] + [w.shape[1] for w in wd[0::2]]
        check(km.fused_mlp_route(dims[0], dims[1:]) == "wgmma",
              f"K3 {label} {dims} is not on the wgmma route")
        x_all = torch.randn((n + 1, dims[0]), generator=g, device=dev)
        x = x_all[:n]

        def run(xb, wd=wd):
            with torch.no_grad():
                return km.fused_mlp(xb, wd)

        def plain(xb, wd=wd):
            with torch.no_grad():
                return km.fused_mlp_plain(xb, wd)

        cases = {}
        for m in (n, n - 3, 1, 63, 64, 65):
            res = {}
            launched = k3_counts(lambda: res.update(out=run(x_all[:m])))
            out, ref = res["out"], plain(x_all[:m])
            cases[f"N={m}"] = dict(err=rel_err(out, ref),
                                   abs=abs_err(out, ref), launches=launched)
            check(launched == want and out.shape == (m, dims[-1])
                  and bool(torch.isfinite(out).all())
                  and cases[f"N={m}"]["err"] <= TOL,
                  f"fused_mlp {label} N={m}: {cases[f'N={m}']}")
        xu = x_all[1:]
        check(xu.data_ptr() % 16 != 0, "the unaligned case is aligned")
        unaligned, ref = run(xu), plain(xu)
        cases["unaligned x"] = dict(err=rel_err(unaligned, ref),
                                    abs=abs_err(unaligned, ref),
                                    same_bits_as_aligned=torch.equal(
                                        unaligned, run(xu.clone())))
        check(cases["unaligned x"]["same_bits_as_aligned"]
              and cases["unaligned x"]["err"] <= TOL,
              f"fused_mlp {label} on an unaligned x: {cases['unaligned x']}")
        deterministic = torch.equal(run(x), run(x))
        check(deterministic, f"fused_mlp {label} differs between two runs")
        k = dict(dims=dims, cases=cases, deterministic=deterministic,
                 ms=device_ms(lambda: run(x), 20, KERNEL_NS),
                 call_ms=cuda_ms(lambda: run(x), 20),
                 plain_ms=device_ms(lambda: plain(x), 20))
        k["bound_ms"], k["bound_by"] = bound(
            2.0 * n * mlp_macs(dims), nbytes(x, *wd) + n * dims[-1] * 4)
        per[label] = k
        log(f"[kernel] fused_mlp {label} [{n},{dims[0]}]->"
            f"{'->'.join(map(str, dims[1:]))} (wgmma): err by case "
            + ", ".join(f"{c}: {v['err']:.2e}" for c, v in cases.items())
            + f"; unaligned x bit-identical to aligned "
            f"{cases['unaligned x']['same_bits_as_aligned']}, two runs "
            f"bit-identical {deterministic}; {k['ms']:.4f} ms (call "
            f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); {card}")
    regs = k3_names(ptxas_registers(report), "3mlp14mlp_fwd")
    spills = k3_names(ptxas_spills(report), "3mlp14mlp_fwd")
    log(f"[build] fused_mlp_fwd registers {regs}, spill bytes {spills}")
    check(all(v == 0 for v in spills.values()), f"fused_mlp_fwd spills {spills}")
    vals = list(per.values())
    return dict(
        shape=" and ".join(f"{label} [{n},{k['dims'][0]}]->"
                           f"{'->'.join(map(str, k['dims'][1:]))}"
                           for label, k in per.items())
        + " (one export chunk, one launch a head)",
        source="cropnerf_tpu_torch/csrc/fused_mlp_fwd.cu",
        replaces="cropnerf_tpu/ops/pallas/fused_mlp.py:30",
        kernel_route="wgmma", by_head=per, registers=regs, spill_bytes=spills,
        deterministic=all(k["deterministic"] for k in vals),
        max_abs_err=max(c["abs"] for k in vals for c in k["cases"].values()),
        rel_err=max(c["err"] for k in vals for c in k["cases"].values()),
        ms=sum(k["ms"] for k in vals), call_ms=sum(k["call_ms"] for k in vals),
        plain_ms=sum(k["plain_ms"] for k in vals),
        bound_ms=sum(k["bound_ms"] for k in vals), bound_by="bytes")


def mlp_bwd_entry(heads, n_of, dev, card, report) -> dict:
    """K3 backward (csrc/fused_mlp_bwd.cu, the wgmma route) on the vanilla
    field's heads at the BayesRays batch (N = n_of[label], or n_of for
    every head), a ragged N and the tiles' edges (N = 1, 63, 64, 65), with
    and without weight gradients,
    against autograd through the plain version; on x and g one float into
    larger buffers (not 16-byte aligned: the same bits as aligned copies);
    two runs bit-identical; each call's launches on the wgmma counter
    alone.  The entry's ms and bound are the two heads' dx-only backwards
    summed (the semantics path runs the semantic head, the rgb path the
    colour head)."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    g = torch.Generator(device=dev).manual_seed(12)
    per = {}
    want = {"fused_mlp": 0, "fused_mlp_stream": 0, "fused_mlp_bwd": 1,
            "fused_mlp_stream_bwd": 0}
    for label, wbs in heads.items():
        n = n_of[label] if isinstance(n_of, dict) else n_of
        wd = [w.detach() for w in wbs]
        din, dout = wd[0].shape[0], wd[-2].shape[1]
        dims = [din] + [w.shape[1] for w in wd[0::2]]
        check(km.fused_mlp_route(din, dims[1:]) == "wgmma",
              f"K3 backward {label} {dims} is not on the wgmma route")
        x_all = torch.randn((n, din), generator=g, device=dev)
        cot_all = torch.randn((n, dout), generator=g, device=dev)

        def plain(xb, cot, need_dw, wd=wd):
            leaves = [xb.clone().requires_grad_(True)] + [
                w.clone().requires_grad_(need_dw) for w in wd]
            with torch.enable_grad():
                out = km.fused_mlp_plain(leaves[0], leaves[1:])
                ask = leaves if need_dw else leaves[:1]
                return list(torch.autograd.grad(out, ask, cot))

        def kernel(xb, cot, need_dw, wd=wd):
            dx, dw = km.fused_mlp_bwd(xb, wd, cot, True, need_dw)
            return [dx] + (dw if need_dw else [])

        errs = {}
        for m in (n, n - 3, 1, 63, 64, 65):
            xb, cot = x_all[:m].contiguous(), cot_all[:m].contiguous()
            for need_dw in (False, True):
                res = {}
                launched = k3_counts(lambda: res.update(
                    got=kernel(xb, cot, need_dw)))
                got, ref = res["got"], plain(xb, cot, need_dw)
                share, l2 = row_agreement(got[0], ref[0])
                w_err, w_l2 = weight_grad_errors(got[1:], ref[1:])
                errs[f"N={m}{' with dW' if need_dw else ' dx only'}"] = dict(
                    rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
                    abs=max(abs_err(a, b) for a, b in zip(got, ref)))
                check(launched == want and share >= ROW_SHARE
                      and l2 <= GRAD_TOL and weight_grads_ok(w_err, w_l2, m),
                      f"fused_mlp_bwd {label} N={m} dW={need_dw}: rows "
                      f"{share:.4f}, dx L2 {l2:.2e}, weights {w_err:.2e}, "
                      f"launches {launched}")
                if m == n:
                    again = kernel(xb, cot, need_dw)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"fused_mlp_bwd {label} differs between two runs")
        # x and g one float into larger buffers: not 16-byte aligned
        xf = torch.empty((n * din + 1,), device=dev)
        gf = torch.empty((n * dout + 1,), device=dev)
        xu, gu = xf[1:].view(n, din), gf[1:].view(n, dout)
        xu.copy_(x_all)
        gu.copy_(cot_all)
        check(xu.data_ptr() % 16 != 0 and gu.data_ptr() % 16 != 0,
              "the unaligned case is aligned")
        unaligned_same = all(
            torch.equal(a, b) for need_dw in (False, True)
            for a, b in zip(kernel(xu, gu, need_dw),
                            kernel(x_all, cot_all, need_dw)))
        check(unaligned_same, f"fused_mlp_bwd {label}: unaligned x and g "
              "change the bits")
        del xf, gf, xu, gu
        xb, cot = x_all, cot_all
        macs = mlp_macs(dims)
        hidden = macs - dims[-2] * dims[-1]
        k = dict(errs=errs, dims=dims, n=n, unaligned_same_bits=unaligned_same,
                 deterministic=True,
                 ms=device_ms(lambda: kernel(xb, cot, False), 20, KERNEL_NS),
                 call_ms=cuda_ms(lambda: kernel(xb, cot, False), 20),
                 plain_ms=device_ms(lambda: plain(xb, cot, False), 5),
                 with_dw_ms=device_ms(lambda: kernel(xb, cot, True), 10,
                                      KERNEL_NS),
                 with_dw_plain_ms=device_ms(lambda: plain(xb, cot, True), 5))
        k["bound_ms"], k["bound_by"] = bound(2.0 * n * (hidden + macs),
                                             nbytes(xb, cot, xb, *wd))
        # the weight gradients add one product and write dW once
        k["with_dw_bound_ms"] = bound(2.0 * n * (hidden + 2 * macs),
                                      nbytes(xb, cot, xb, *wd) + nbytes(*wd))[0]
        per[label] = k
        log(f"[kernel] fused_mlp_bwd {label} [{n},{din}]->"
            f"{'->'.join(map(str, dims[1:]))} (wgmma): rows/L2/weights by "
            "case " + ", ".join(f"{c}: {v['rows']:.5f}/{v['dx_l2']:.2e}/"
                                f"{v['w_err']:.2e}" for c, v in errs.items())
            + f"; unaligned x and g bit-identical to aligned {unaligned_same}"
            f"; dx only {k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); with dW {k['with_dw_ms']:.4f} ms, plain "
            f"{k['with_dw_plain_ms']:.4f} ms, bound "
            f"{k['with_dw_bound_ms']:.4f} ms; {card}")
    regs = k3_names(ptxas_registers(report), "3mlp14mlp_bwd")
    spills = k3_names(ptxas_spills(report), "3mlp14mlp_bwd")
    log(f"[build] fused_mlp_bwd registers {regs}, spill bytes {spills}")
    check(all(v == 0 for v in spills.values()), f"fused_mlp_bwd spills {spills}")
    vals = list(per.values())
    return dict(
        shape=" and ".join(f"{label} [{k['n']},{k['dims'][0]}]->"
                           f"{'->'.join(map(str, k['dims'][1:]))}"
                           for label, k in per.items())
        + ", g -> dx (BayesRays: no weight gradient)",
        source="cropnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
        replaces="cropnerf_tpu/ops/pallas/fused_mlp.py:45",
        kernel_route="wgmma", by_head=per, registers=regs, spill_bytes=spills,
        max_abs_err=max(e["abs"] for k in vals for e in k["errs"].values()),
        rel_err=max(e["dx_l2"] for k in vals for e in k["errs"].values()),
        ms=sum(k["ms"] for k in vals), call_ms=sum(k["call_ms"] for k in vals),
        plain_ms=sum(k["plain_ms"] for k in vals),
        with_dw_ms=sum(k["with_dw_ms"] for k in vals),
        bound_ms=sum(k["bound_ms"] for k in vals), bound_by="bytes")


# the stream route's nets (csrc/fused_mlp_stream.cu), which the
# resident-weight kernels do not take.  K3: -huge's semantic head at 256
# wide (the [prop256] phase's -huge, at its 64-side export's chunk and its
# BayesRays batch) and -huge's colour head with a second 256-wide hidden
# layer (no preset builds it), at an export chunk and cropnerf-mxu's
# BayesRays batch.  K5: [prop256]'s proposal nets, 3 layers 256 wide, at a
# training step's batches (4096 rays x 256 and x 96 samples), and a 4-layer
# net 64 wide (-mxu's second net with a third hidden layer) at net 1's.
# The first K3 net and the K5 [prop256] nets are the main path's.
STREAM_K3 = {"-huge semantic head 256 wide": ([30, 256, 256, 1], 512 * 64,
                                              RAYS * 64),
             "3-layer 256-wide net": ([89, 256, 256, 3], 512 * 128,
                                      RAYS * 48)}
STREAM_K5 = {"[prop256] net 0": (5, 256, 3, RAYS * 256),
             "[prop256] net 1": (6, 256, 3, RAYS * 96),
             "4-layer net": (6, 64, 4, RAYS * 96)}
STREAM_FWD_PASSES = {"kernel": ("mlp_stream_fwd_kernel",)}
STREAM_BWD_PASSES = {"tile": ("mlp_stream_bwd_kernel",),
                     "dw": ("pe_field_bwd_dw_kernel",),
                     "sums": ("chunk_sum_kernel", "column_sum_kernel")}


def stream_counts(fn) -> dict:
    """Launches of the stream route's four counters during ``fn()``."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    return counted((km.fused_mlp_stream, km.fused_mlp_stream_bwd,
                    kf.fused_pe_mlp_stream, kf.fused_pe_mlp_stream_bwd), fn)


def stream_net_entry(label, dims, n_fwd, n_bwd, F, dev, card,
                     report: str = "") -> dict:
    """One stream net, K3 (F None: x [N, dims[0]]) or K5 (x [N, 3] encoded
    with F frequencies into dims[0] columns): the forward at n_fwd, a
    ragged N and N = 1, and the backward at n_bwd with dx and the weight
    gradients, dx alone (K3's BayesRays variant) and the weight gradients
    alone, against the plain version (dx row by row, the weight gradients
    in relative L2); dx alone and dW alone the full backward's bits; two
    runs bit-identical; each call's launches on its stream counter alone;
    device ms by pass, plain ms and bounds; the backward's persistent
    clusters (cluster_report, with and without dW; ``report`` is the
    library's ptxas report)."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    from cropnerf_tpu_torch.ops.cuda import mlp_plan
    pe = F is not None
    g = torch.Generator(device=dev).manual_seed(16)
    wd = []
    for a, b in zip(dims[:-1], dims[1:]):
        wd += [torch.randn((a, b), generator=g, device=dev) / a ** 0.5,
               torch.randn((1, b), generator=g, device=dev) * 0.05]
    n = max(n_fwd, n_bwd)
    x_all = ((torch.rand((n, 3), generator=g, device=dev) * 2 - 1) if pe
             else torch.randn((n, dims[0]), generator=g, device=dev))
    cot_all = torch.randn((n, dims[-1]), generator=g, device=dev)
    route = (kf.pe_mlp_fwd_route(3, F, dims[1:]) if pe
             else km.fused_mlp_route(dims[0], dims[1:]))
    check(route == "stream", f"{label} {dims} is not on the stream route")
    fname, bname = (("fused_pe_mlp_stream", "fused_pe_mlp_stream_bwd") if pe
                    else ("fused_mlp_stream", "fused_mlp_stream_bwd"))

    def fwd(xb):
        with torch.no_grad():
            return kf.fused_pe_mlp(xb, wd, F) if pe else km.fused_mlp(xb, wd)

    def plain_fwd(xb):
        with torch.no_grad():
            return (kf.fused_pe_mlp_plain(xb, wd, F) if pe
                    else km.fused_mlp_plain(xb, wd))

    def bwd(xb, cb, need_dx=True, need_dw=True):
        dx, dw = (kf.fused_pe_mlp_bwd(xb, wd, F, cb, need_dx, need_dw) if pe
                  else km.fused_mlp_bwd(xb, wd, cb, need_dx, need_dw))
        return [dx] + (dw or [])

    def plain_bwd(xb, cb, need_dw=True):
        leaves = [xb.clone().requires_grad_(True)] + [
            w.clone().requires_grad_(need_dw) for w in wd]
        with torch.enable_grad():
            out = (kf.fused_pe_mlp_plain(leaves[0], leaves[1:], F) if pe
                   else km.fused_mlp_plain(leaves[0], leaves[1:]))
            return list(torch.autograd.grad(
                out, leaves if need_dw else leaves[:1], cb))

    want_f = {"fused_mlp_stream": 0, "fused_mlp_stream_bwd": 0,
              "fused_pe_mlp_stream": 0, "fused_pe_mlp_stream_bwd": 0}
    want_b = dict(want_f, **{bname: 1})
    want_f[fname] = 1
    cases, res = {}, {}
    for m in (n_fwd, n_fwd - 3, 1):
        xb = x_all[:m].contiguous()
        launched = stream_counts(lambda: res.update(out=fwd(xb)))
        out, ref = res["out"], plain_fwd(xb)
        cases[f"forward N={m}"] = c = dict(err=rel_err(out, ref),
                                           abs=abs_err(out, ref))
        check(launched == want_f and out.shape == (m, dims[-1])
              and bool(torch.isfinite(out).all()) and c["err"] <= TOL,
              f"{fname} {label} N={m}: {c}, launches {launched}")
    for m in (n_bwd, n_bwd - 77, 1):
        xb, cb = x_all[:m].contiguous(), cot_all[:m].contiguous()
        launched = stream_counts(lambda: res.update(got=bwd(xb, cb)))
        got, ref = res["got"], plain_bwd(xb, cb)
        share, l2 = row_agreement(got[0], ref[0])
        w_err, w_l2 = weight_grad_errors(got[1:], ref[1:])
        cases[f"backward N={m}"] = c = dict(
            rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
            abs=max(abs_err(a, b) for a, b in zip(got, ref)))
        check(launched == want_b and share >= ROW_SHARE and l2 <= GRAD_TOL
              and weight_grads_ok(w_err, w_l2, m),
              f"{bname} {label} N={m}: {c}, launches {launched}")
        if m == n_bwd:
            dx_only = bwd(xb, cb, True, False)
            dw_only = bwd(xb, cb, False, True)[1:]
            again = bwd(xb, cb)
            c["asks_same_bits"] = (torch.equal(dx_only[0], got[0]) and all(
                torch.equal(a, b) for a, b in zip(dw_only, got[1:])))
            c["deterministic"] = all(torch.equal(a, b)
                                     for a, b in zip(got, again))
            check(c["asks_same_bits"] and c["deterministic"],
                  f"{bname} {label}: dx alone / dW alone / a second run "
                  "differ from the full backward")
            del dx_only, dw_only, again
        del got, ref
    xf, xb, cb = (x_all[:n_fwd].contiguous(), x_all[:n_bwd].contiguous(),
                  cot_all[:n_bwd].contiguous())
    fwd_same = torch.equal(fwd(xf), fwd(xf))
    check(fwd_same, f"{fname} {label} differs between two runs")
    macs = mlp_macs(dims)
    hidden = macs - dims[-2] * dims[-1]
    w_bytes = nbytes(*wd)
    bwd_names, dx_names = {}, {}
    k = dict(dims=dims, n_fwd=n_fwd, n_bwd=n_bwd, num_freqs=F, cases=cases,
             forward_deterministic=fwd_same,
             fwd_passes=pass_ms(lambda: fwd(xf), 10, STREAM_FWD_PASSES),
             call_ms=cuda_ms(lambda: fwd(xf), 10),
             plain_ms=device_ms(lambda: plain_fwd(xf), 5),
             bwd_passes=pass_ms(lambda: bwd(xb, cb), 5, STREAM_BWD_PASSES,
                                bwd_names),
             bwd_call_ms=cuda_ms(lambda: bwd(xb, cb), 5),
             bwd_plain_ms=device_ms(lambda: plain_bwd(xb, cb), 3),
             dx_passes=pass_ms(lambda: bwd(xb, cb, True, False), 5,
                               STREAM_BWD_PASSES, dx_names),
             dx_plain_ms=device_ms(lambda: plain_bwd(xb, cb, False), 3))
    k["ms"] = k["fwd_passes"]["total"]["median"]
    k["bwd_ms"] = k["bwd_passes"]["total"]["median"]
    k["dx_ms"] = k["dx_passes"]["total"]["median"]
    # the forward reads x and the weights and writes y; the backward
    # recomputes the hidden layers, then every input gradient (and every
    # weight gradient), reading x, g and the weights and writing dx (and
    # dW); the workspace the weight gradients go through is the design's
    # cost, not the function's
    io = 3 * 4 if pe else dims[0] * 4
    k["bound_ms"], k["bound_by"] = bound(
        2.0 * n_fwd * macs, n_fwd * (io + dims[-1] * 4) + w_bytes)
    k["bwd_bound_ms"], k["bwd_bound_by"] = bound(
        2.0 * n_bwd * (hidden + 2 * macs),
        n_bwd * (2 * io + dims[-1] * 4) + 2 * w_bytes)
    k["dx_bound_ms"], k["dx_bound_by"] = bound(
        2.0 * n_bwd * (hidden + macs),
        n_bwd * (2 * io + dims[-1] * 4) + w_bytes)
    regs = kernel_names_plain(ptxas_registers(report))
    spills = kernel_names_plain(ptxas_spills(report))
    fkey = mlp_plan.program_key(dims[0], dims[1:], 3 if pe else 0,
                                F if pe else 0, False)
    fh = mlp_plan.stream_plan(fkey).header
    kn = f"mlp_stream_fwd_kernel<{bool_word(mlp_plan.stream_wide(fh))}>"
    k["fwd_cluster"] = fwd_cluster_report(
        f"stream {label} forward", km.stream_fwd_grid(fkey, n_fwd), n_fwd,
        fh[mlp_plan.M_IMG_ELEMS] * 2, k["ms"], k["bound_ms"],
        {kn: regs.get(kn)}, {kn: spills.get(kn)}, card)
    for what, need_dw, names in (("with dW", True, bwd_names),
                                 ("dx alone", False, dx_names)):
        key = mlp_plan.program_key(dims[0], dims[1:], 3 if pe else 0,
                                   F if pe else 0, True, True, need_dw)
        h = mlp_plan.stream_plan(key).header
        wide = mlp_plan.stream_wide(h)
        kn = f"mlp_stream_bwd_kernel<{bool_word(need_dw)}, {bool_word(wide)}>"
        k["cluster" if need_dw else "dx_cluster"] = cluster_report(
            f"stream {label} backward, {what}", km.stream_bwd_grid(key, n_bwd),
            n_bwd, 2 if wide else 1, h[mlp_plan.M_IMG_ELEMS] * 2,
            k["bwd_passes" if need_dw else "dx_passes"],
            k["bwd_bound_ms" if need_dw else "dx_bound_ms"],
            {kn: regs.get(kn)}, {kn: spills.get(kn)}, names, card)
    arrow = "->".join(map(str, dims[1:]))
    log(f"[kernel] stream {label}: x [{n_fwd},{3 if pe else dims[0]}]"
        f"{f' (F={F})' if pe else ''} -> {dims[0]} -> {arrow}: forward "
        f"{k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}); backward at N={n_bwd} with dx and dW "
        f"{k['bwd_ms']:.4f} ms (call {k['bwd_call_ms']:.4f}; by pass over "
        f"{BWD_WINDOWS} windows, median (min-max): "
        f"{fmt_passes(k['bwd_passes'])}), plain {k['bwd_plain_ms']:.4f} ms, "
        f"bound {k['bwd_bound_ms']:.4f} ms ({k['bwd_bound_by']}); dx alone "
        f"{k['dx_ms']:.4f} ms, plain {k['dx_plain_ms']:.4f} ms, bound "
        f"{k['dx_bound_ms']:.4f} ms ({k['dx_bound_by']}); errors "
        + ", ".join(f"{c_}: {v}" for c_, v in cases.items()) + f"; {card}")
    del x_all, cot_all
    return k


def stream_entries(dev, card, report) -> dict:
    """The stream route's kernels (csrc/fused_mlp_stream.cu) at STREAM_K3
    and STREAM_K5 (stream_net_entry), the kernel line's four entries: K3's
    forward and backward (main path: -huge's semantic head at 256 wide,
    its export chunk, and its BayesRays batch's dx alone) and K5's (main
    path: [prop256]'s two proposal nets, one training step's calls summed,
    the backward with dx and dW); the other nets in by_net.  Launches are
    filled in from the [prop256] phase."""
    k3 = {label: stream_net_entry(label, dims, nf, nb, None, dev, card,
                                  report)
          for label, (dims, nf, nb) in STREAM_K3.items()}
    k5 = {label: stream_net_entry(label, [3 * (1 + 2 * F)] + [hw] * (
        layers - 1) + [1], n, n, F, dev, card, report)
        for label, (F, hw, layers, n) in STREAM_K5.items()}
    regs = kernel_names_plain(ptxas_registers(report))
    spills = kernel_names_plain(ptxas_spills(report))
    log(f"[build] fused_mlp_stream registers {regs}, spill bytes {spills}")
    check(all(v == 0 for v in spills.values()),
          f"fused_mlp_stream spills {spills}")
    return stream_line(k3, k5, "-huge semantic head 256 wide",
                       ["[prop256] net 0", "[prop256] net 1"],
                       "-huge's semantic head at 256 wide", "[prop256]'s",
                       regs, spills)


def stream_line(k3, k5, label3, labels5, what3, what5, regs, spills,
                route="stream") -> dict:
    """The kernel line's four stream-route entries from stream_net_entry's
    nets: K3's forward at net ``label3``'s export chunk and its dx alone at
    its BayesRays batch, K5's forward and backward with dW summed over a
    training step's two nets ``labels5``; every net in by_net."""
    main3, main5 = k3[label3], [k5[label] for label in labels5]

    def errs(ks, kind):
        cs = [c for k in ks for name, c in k["cases"].items()
              if name.startswith(kind)]
        if kind == "forward":
            return max(c["err"] for c in cs), max(c["abs"] for c in cs)
        return max(c["dx_l2"] for c in cs), max(c["abs"] for c in cs)

    def entry(ks, kind, **kw):
        rel, ab = errs(ks, kind)
        return dict(source="cropnerf_tpu_torch/csrc/fused_mlp_stream.cu",
                    kernel_route=route, registers=regs, spill_bytes=spills,
                    rel_err=rel, max_abs_err=ab, **kw)

    src = "cropnerf_tpu/ops/pallas/"
    dims3 = "->".join(map(str, main3["dims"]))
    shape5 = " and ".join(f"x [{k['n_fwd']},3] -> "
                          f"{'->'.join(map(str, k['dims']))}" for k in main5)
    return {
        "fused_mlp_stream": entry(
            [main3], "forward", by_net=k3,
            shape=f"{what3}, [{main3['n_fwd']}] x {dims3} (one chunk of the "
                  "64-side export)",
            replaces=src + "fused_mlp.py:30", ms=main3["ms"],
            call_ms=main3["call_ms"], plain_ms=main3["plain_ms"],
            bound_ms=main3["bound_ms"], bound_by=main3["bound_by"]),
        "fused_mlp_stream_bwd": entry(
            [main3], "backward", by_net=k3,
            shape=f"its dx alone at a BayesRays batch, [{main3['n_bwd']}] x "
                  f"{dims3}",
            replaces=src + "fused_mlp.py:45", ms=main3["dx_ms"],
            cluster=main3["dx_cluster"], with_dw_cluster=main3["cluster"],
            with_dw_ms=main3["bwd_ms"], call_ms=main3["bwd_call_ms"],
            plain_ms=main3["dx_plain_ms"], bound_ms=main3["dx_bound_ms"],
            bound_by=main3["dx_bound_by"]),
        "fused_pe_mlp_stream": entry(
            main5, "forward", by_net=k5,
            shape=f"{what5} two proposal nets, one training step: {shape5}",
            replaces=src + "fused_pe_field.py:822",
            ms=sum(k["ms"] for k in main5),
            call_ms=sum(k["call_ms"] for k in main5),
            plain_ms=sum(k["plain_ms"] for k in main5),
            bound_ms=sum(k["bound_ms"] for k in main5),
            bound_by="operations"),
        "fused_pe_mlp_stream_bwd": entry(
            main5, "backward", by_net=k5,
            shape=f"their backward with dx and every weight gradient: "
                  f"{shape5}",
            replaces=src + "fused_pe_field.py:835",
            cluster=[k["cluster"] for k in main5],
            ms=sum(k["bwd_ms"] for k in main5),
            call_ms=sum(k["bwd_call_ms"] for k in main5),
            plain_ms=sum(k["bwd_plain_ms"] for k in main5),
            bound_ms=sum(k["bwd_bound_ms"] for k in main5),
            bound_by="operations")}


def kernel_names_plain(per_entry: dict) -> dict:
    """Mangled names of csrc/fused_mlp_stream.cu's kernels -> short names
    (mlp_stream_fwd_kernel<WIDE>, mlp_stream_bwd_kernel<STORE, WIDE> and
    the weight-gradient pass's)."""
    out = {}
    for name, v in per_entry.items():
        m = re.search(r"([A-Za-z_]+_kernel)", name)
        if m:
            out[m.group(1) + bool_args(name)] = v
    return out


def uncertainty_phase(dev, card, bank, cams, kernels) -> tuple:
    """The BayesRays pass at full width on the resident bank: lod 8, RAYS
    rays a batch, UNC_BATCHES batches, the semantics channel, for
    cropnerf-mxu (then one rgb-channel batch) and cropnerf, with exact
    launch counts (counts zeroed just before each run and read just after)
    and the kernel path held against the plain path; then the per-ray
    uncertainty and a RENDER_HW^2 render filtered at UNC_THRESHOLD through
    make_render_fn's density hook, each timed and held against the plain
    path, at UNC_THRESHOLD and at the median uncertainty of a batch's
    samples (random weights give a grid that 0.5 may filter whole).
    Returns (numbers for the JSON line, one batch call per preset for the
    trace)."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import _proposal_sampling, model_init
    from cropnerf_tpu_torch.train.step import make_render_fn
    from cropnerf_tpu_torch.uncertainty import bayesrays as br
    out, trace_steps = {}, {}
    for preset in ("cropnerf-mxu", "cropnerf"):
        cfg = PRESETS[preset]
        m = cfg.model
        if preset == "cropnerf":
            plain_cfg = plain_grids(cfg)
        else:
            plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                m, field=dataclasses.replace(m.field, mlp_impl="xla")))
        params = model_init(m, bank.num_images, torch.Generator().manual_seed(0),
                            dev)
        with torch.no_grad():
            gg = torch.Generator(device=dev).manual_seed(6)
            for name, prm in params.named_parameters():
                if name.endswith("grid"):
                    prm.uniform_(-0.5, 0.5, generator=gg)
        batches = list(br.bank_ray_batches(
            bank, m, UNC_BATCHES, RAYS, torch.Generator(device=dev).manual_seed(9)))
        comp = br.ComputeUncertainty(params, m, lod=UNC_LOD)
        per_batch = ({"hash_encode": 3, "hash_encode_bwd": 1}
                     if preset == "cropnerf" else
                     {"fused_pe_density": 1, "fused_pe_density_bwd": 1,
                      "fused_mlp": 1, "fused_mlp_bwd": 1})
        want = {k.__name__: UNC_BATCHES * per_batch.get(k.__name__, 0)
                for k in kernels}
        grid, runs = [], []

        def run_all():
            acc = None
            for rb in batches:
                t0 = time.perf_counter()
                h = comp.batch(rb)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
                acc = h if acc is None else acc + h
            grid.append(acc)

        launches = counted(kernels, run_all)
        log(f"[uncertainty] {preset} launches in {UNC_BATCHES} batches: "
            f"{launches}")
        check(launches == want, f"{preset} uncertainty launches {launches}, "
              f"expected {want}")
        hess = grid[0]
        check(bool(torch.isfinite(hess).all()) and hess.max() > 0
              and hess.shape == ((2 ** UNC_LOD + 1) ** 3,),
              f"{preset} Hessian grid")
        check(all(p.requires_grad for p in params.parameters()),
              "the pass left parameters frozen")
        check(torch.equal(comp.batch(batches[0]), comp.batch(batches[0])),
              f"{preset} Hessian batch differs between two runs")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comp.batch(batches[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_comp = br.ComputeUncertainty(params, plain_cfg.model, lod=UNC_LOD)
        plain_runs, plain_hess = [], None
        for rb in batches:
            t0 = time.perf_counter()
            h = plain_comp.batch(rb)
            torch.cuda.synchronize()
            plain_runs.append((time.perf_counter() - t0) * 1e3)
            plain_hess = h if plain_hess is None else plain_hess + h
        l2 = ((hess - plain_hess).norm() / plain_hess.norm()).item()
        hot = len(set(hess.topk(1000).indices.tolist())
                  & set(plain_hess.topk(1000).indices.tolist())) / 1000
        med = statistics.median(runs[1:])
        touched = int((hess > 0).sum())
        info = {"batches": UNC_BATCHES, "rays": RAYS, "lod": UNC_LOD,
                "runs_ms": runs, "median_ms": med,
                "batches_per_s": 1e3 / med, "rays_per_s": RAYS / med * 1e3,
                "first_ms": runs[0], "peak_gib": peak,
                "plain_runs_ms": plain_runs,
                "plain_median_ms": statistics.median(plain_runs[1:]),
                "launches": launches, "vs_plain_l2": l2, "hot1000": hot,
                "cells_touched": touched}
        log(f"[uncertainty] {preset} lod {UNC_LOD}, {RAYS} rays a batch: "
            f"median {med:.2f} ms a batch ({1e3 / med:.2f} batches/s, "
            f"{RAYS / med * 1e3:.0f} rays/s), runs "
            + ", ".join(f"{v:.2f}" for v in runs)
            + f" ms; plain path median {info['plain_median_ms']:.2f} ms; "
            f"peak device memory {peak:.3f} GiB; {touched} cells touched; "
            f"vs plain path: relative L2 {l2:.3e}, hottest 1000 cells "
            f"shared {hot:.3f}; {card}")
        check(l2 <= (1e-3 if preset == "cropnerf" else GRAD_TOL) and hot >= 0.9,
              f"{preset} Hessian vs plain path: L2 {l2:.3e}, hot {hot:.3f}")

        if preset == "cropnerf-mxu":
            rgb = br.ComputeUncertainty(params, m, lod=UNC_LOD, channel="rgb")
            res = {}
            rgb_launches = counted(kernels, lambda: res.update(
                h=rgb.batch(batches[0])))
            want_rgb = {k.__name__: 0 for k in kernels}
            want_rgb.update(fused_pe_density=1, fused_pe_density_bwd=3,
                            fused_mlp=1, fused_mlp_bwd=3)
            log(f"[uncertainty] {preset} rgb channel, one batch: launches "
                f"{rgb_launches}")
            check(rgb_launches == want_rgb, f"rgb launches {rgb_launches}, "
                  f"expected {want_rgb}")
            ref = br.ComputeUncertainty(params, plain_cfg.model, lod=UNC_LOD,
                                        channel="rgb").batch(batches[0])
            info["rgb_launches"] = rgb_launches
            info["rgb_vs_plain_l2"] = ((res["h"] - ref).norm()
                                       / ref.norm()).item()
            info["rgb_ms"] = wall_ms(lambda: rgb.batch(batches[0]))
            log(f"[uncertainty] {preset} rgb channel: {info['rgb_ms']:.2f} ms "
                f"a batch; vs plain path relative L2 "
                f"{info['rgb_vs_plain_l2']:.3e}; {card}")
            check(info["rgb_vs_plain_l2"] <= GRAD_TOL, "rgb channel vs plain")

        # the filtered paths, with the viewer's uncertainty normaliser
        rb = batches[0]
        got = {}
        wall_ms(lambda: got.update(u=br.render_uncertainty(
            params, rb, m, hess, UNC_LOD, UNC_VIEW_SAMPLES)))
        unc_ms = statistics.median(
            [wall_ms(lambda: br.render_uncertainty(params, rb, m, hess, UNC_LOD,
                                                   UNC_VIEW_SAMPLES))
             for _ in range(REPEATS)])
        u_plain = br.render_uncertainty(params, rb, plain_cfg.model, hess,
                                        UNC_LOD, UNC_VIEW_SAMPLES)
        u_err = rel_err(got["u"], u_plain)
        check(bool(torch.isfinite(got["u"]).all()) and got["u"].shape == (RAYS,)
              and u_err <= 2 * TOL, f"{preset} render_uncertainty")
        # a second threshold, the median pointwise uncertainty of the
        # batch's samples, keeps about half of them whatever the weights
        with torch.no_grad():
            samples, _, _ = _proposal_sampling(params, rb, m, False, 1.0)
            mid = br.uncertainty_at(samples.positions, hess, m, UNC_LOD,
                                    UNC_VIEW_SAMPLES).median().item()
        hook = br.make_uncertainty_density_hook(hess, m, UNC_LOD,
                                                UNC_VIEW_SAMPLES)
        render = make_render_fn(cfg, density_hook=hook)
        render_p = make_render_fn(plain_cfg, density_hook=hook)
        unfiltered = make_render_fn(cfg)(params, cams, 0, RENDER_HW, RENDER_HW)
        acc_all = unfiltered["accumulation"].mean().clamp_min(1e-12)
        filt = {}
        for thr in (UNC_THRESHOLD, mid):
            img = {}
            n_launch = counted(kernels, lambda: img.update(
                f=render(params, cams, 0, RENDER_HW, RENDER_HW, thr)))
            img_p = render_p(params, cams, 0, RENDER_HW, RENDER_HW, thr)
            errs = {k: rel_err(img["f"][k], img_p[k])
                    for k in ("rgb", "accumulation", "semantics")}
            for k, v in errs.items():
                check(bool(torch.isfinite(img["f"][k]).all()) and v <= 2 * TOL,
                      f"{preset} filtered render {k} at {thr:.4f}: {v:.3e}")
            filt[round(thr, 6)] = dict(
                launches=n_launch, vs_plain=errs,
                accumulation_share=(img["f"]["accumulation"].mean()
                                    / acc_all).item())
        kept = filt[round(mid, 6)]["accumulation_share"]
        check(0.0 < kept < 1.0, f"{preset}: the filter at the median "
              f"uncertainty {mid:.4f} kept {kept:.3f} of the accumulation")
        render_ms = statistics.median(
            [wall_ms(lambda: render(params, cams, 0, RENDER_HW, RENDER_HW,
                                    UNC_THRESHOLD)) for _ in range(REPEATS)])
        info.update(render_uncertainty_ms=unc_ms, render_uncertainty_err=u_err,
                    filtered_render_ms=render_ms,
                    filtered_render_rays_per_s=RENDER_HW ** 2 / render_ms * 1e3,
                    unfiltered_render_ms=wall_ms(lambda: make_render_fn(cfg)(
                        params, cams, 0, RENDER_HW, RENDER_HW)),
                    median_threshold=mid, filtered=filt)
        log(f"[uncertainty] {preset} render_uncertainty {RAYS} rays: median "
            f"{unc_ms:.2f} ms, vs plain path {u_err:.3e}; filtered render "
            f"{RENDER_HW}x{RENDER_HW} at threshold {UNC_THRESHOLD}: median "
            f"{render_ms:.2f} ms ({RENDER_HW ** 2 / render_ms * 1e3:.0f} "
            f"rays/s; unfiltered {info['unfiltered_render_ms']:.2f} ms); by "
            f"threshold (launches, vs plain path, accumulation share of the "
            f"unfiltered render): {filt}; {card}")
        out[preset] = info
        trace_steps[f"{preset} uncertainty batch"] = (
            lambda comp=comp, rb=rb: comp.batch(rb))
        del params, comp, plain_comp, batches, hess, plain_hess
    return out, trace_steps


# ---- slice 5: K5 (fused PE proposal nets), K6 (transmittance), [propfused] --

def propfused_cfg(cfg, prop_hidden: int | None = None):
    """cropnerf-mxu with both PE proposal nets on the fused kernel, as
    benchmarks/ab_pe_fused.py builds it (pallas-fused:pallas-fused); with
    ``prop_hidden`` both nets that wide, as benchmarks/ab_propshape.py
    builds its arms."""
    m = cfg.model
    more = {} if prop_hidden is None else {"hidden_dim": prop_hidden}
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, proposal_fields=tuple(dataclasses.replace(
            p, mlp_impl="pallas-fused", **more) for p in m.proposal_fields)))


def all_plain_cfg(cfg):
    """``cfg`` with the field and the proposal nets on plain matmuls."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, mlp_impl="xla"),
        proposal_fields=tuple(dataclasses.replace(p, mlp_impl="xla")
                              for p in m.proposal_fields)))


def pe_mlp_entries(cfg, dev, card, reports, kernels) -> dict:
    """K5 forward (csrc/fused_pe_mlp_fwd.cu) and backward
    (csrc/fused_pe_mlp_bwd.cu) against the plain version at one
    cropnerf-mxu training step's shapes of both proposal nets (4096 rays x
    256 and x 96 samples), a ragged N and N < 64; the backward with dx and
    the weight gradients, the variant the training step runs (its samples
    carry the camera-opt graph).  Each entry's ms, plain ms and bound are
    the two nets' summed: one training step's calls; the kernels' times
    are the median of BWD_WINDOWS profiler windows.  cropnerf-mxu-q's
    128-wide nets are pe_mlp_wide_entries', the stream route's nets
    stream_entries'."""
    from cropnerf_tpu_torch.models.proposal import proposal_init
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    m, R = cfg.model, cfg.train_num_rays_per_batch
    g = torch.Generator(device=dev).manual_seed(13)

    def net(p, seed):
        prop = proposal_init(p, torch.Generator().manual_seed(seed), dev)
        return [t.detach() for w, b in zip(prop.mlp.w, prop.mlp.b)
                for t in (w, b.reshape(1, -1))]

    per = {}
    for i, (p, smp) in enumerate(zip(m.proposal_fields,
                                     m.num_proposal_samples_per_ray)):
        n, F = R * smp, p.pe_freqs
        wd = net(p, i)
        dims = [3 * (1 + 2 * F)] + [w.shape[1] for w in wd[0::2]]
        check(kf.pe_mlp_fwd_route(3, F, dims[1:]) == "wgmma",
              f"proposal net {i} {dims} is not on the wgmma route")
        x_all = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        cot_all = torch.randn((n, 1), generator=g, device=dev)

        def fwd(xb, wd=wd, F=F):
            with torch.no_grad():
                return kf.fused_pe_mlp(xb, wd, F)

        def plain_fwd(xb, wd=wd, F=F):
            with torch.no_grad():
                return kf.fused_pe_mlp_plain(xb, wd, F)

        def bwd(xb, cot, wd=wd, F=F):
            dx, dw = kf.fused_pe_mlp_bwd(xb, wd, F, cot, True, True)
            return [dx] + dw

        def plain_bwd(xb, cot, wd=wd, F=F):
            leaves = [xb.clone().requires_grad_(True)] + [
                w.clone().requires_grad_(True) for w in wd]
            with torch.enable_grad():
                out = kf.fused_pe_mlp_plain(leaves[0], leaves[1:], F)
                return list(torch.autograd.grad(out, leaves, cot))

        cases = {}
        for nc in (n, n - 77, 50):
            xb, cot = x_all[:nc].contiguous(), cot_all[:nc].contiguous()
            out, ref = fwd(xb), plain_fwd(xb)
            got_g, ref_g = bwd(xb, cot), plain_bwd(xb, cot)
            share, l2 = row_agreement(got_g[0], ref_g[0])
            w_err, w_l2 = weight_grad_errors(got_g[1:], ref_g[1:])
            cases[f"N={nc}"] = c = dict(
                fwd_err=rel_err(out, ref), fwd_abs=abs_err(out, ref),
                rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
                bwd_abs=max(abs_err(a, b) for a, b in zip(got_g, ref_g)))
            check(out.shape == (nc, 1) and bool(torch.isfinite(out).all())
                  and c["fwd_err"] <= TOL, f"fused_pe_mlp net {i} N={nc}: "
                  f"{c['fwd_err']:.2e}")
            check(share >= ROW_SHARE and l2 <= GRAD_TOL
                  and weight_grads_ok(w_err, w_l2, nc),
                  f"fused_pe_mlp_bwd net {i} N={nc}: rows {share:.4f}, dx L2 "
                  f"{l2:.2e}, weights {w_err:.2e} (L2 {w_l2:.2e})")
            if nc == n:
                again = bwd(xb, cot)
                c["deterministic"] = (torch.equal(out, fwd(xb)) and all(
                    torch.equal(a, b) for a, b in zip(got_g, again)))
                check(c["deterministic"], f"fused_pe_mlp net {i} differs "
                      "between two runs")
            del got_g, ref_g
        xb, cot = x_all, cot_all
        macs = mlp_macs(dims)
        hidden = macs - dims[-2] * dims[-1]
        k = dict(n=n, num_freqs=F, dims=dims, cases=cases,
                 fwd_passes=pass_ms(lambda: fwd(xb), 20, PE_MLP_FWD_PASSES),
                 call_ms=cuda_ms(lambda: fwd(xb), 20),
                 plain_ms=device_ms(lambda: plain_fwd(xb), 5),
                 bwd_passes=pass_ms(lambda: bwd(xb, cot), 10,
                                    PE_MLP_BWD_PASSES),
                 bwd_call_ms=cuda_ms(lambda: bwd(xb, cot), 10),
                 bwd_plain_ms=device_ms(lambda: plain_bwd(xb, cot), 5))
        k["ms"] = k["fwd_passes"]["total"]["median"]
        k["bwd_ms"] = k["bwd_passes"]["total"]["median"]
        # tensor-core products only (the encoding's sin/cos are ~30
        # transcendentals a row against ~6,300 multiply-adds); the backward
        # recomputes the hidden layers, then every input gradient and every
        # weight gradient
        k["bound_ms"], k["bound_by"] = bound(2.0 * n * macs,
                                             nbytes(xb, *wd) + n * 4)
        k["bwd_bound_ms"], k["bwd_bound_by"] = bound(
            2.0 * n * (hidden + 2 * macs), nbytes(xb, cot, xb, *wd, *wd))
        per[f"net {i}"] = k
        log(f"[kernel] fused_pe_mlp net {i} [{n},3] -> "
            f"{'->'.join(map(str, dims))} (F={F}): err by case "
            + ", ".join(f"{c_}: fwd {v['fwd_err']:.2e}, dx rows {v['rows']:.5f}"
                        f"/L2 {v['dx_l2']:.2e}, weights {v['w_err']:.2e}/L2 "
                        f"{v['w_l2']:.2e}" for c_, v in cases.items())
            + f"; forward {k['ms']:.4f} ms (call {k['call_ms']:.4f}; over "
            f"{BWD_WINDOWS} windows, median (min-max): "
            f"{fmt_passes(k['fwd_passes'])}), plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}); backward with "
            f"dx and dW {k['bwd_ms']:.4f} ms (call {k['bwd_call_ms']:.4f}; by "
            f"pass over {BWD_WINDOWS} windows, median (min-max): "
            f"{fmt_passes(k['bwd_passes'])}), plain {k['bwd_plain_ms']:.4f} "
            f"ms, bound {k['bwd_bound_ms']:.4f} ms ({k['bwd_bound_by']}); "
            f"{card}")
        del x_all, cot_all

    regs = ptxas_registers(reports["fused_pe_mlp_fwd"])
    spills = ptxas_spills(reports["fused_pe_mlp_fwd"])
    bwd_regs = ptxas_registers(reports["fused_pe_mlp_bwd"])
    bwd_spills = ptxas_spills(reports["fused_pe_mlp_bwd"])
    log(f"[build] fused_pe_mlp_fwd registers {regs}, spill bytes {spills}; "
        f"fused_pe_mlp_bwd registers {bwd_regs}, spill bytes {bwd_spills}")
    check(all(v == 0 for v in spills.values()),
          f"fused_pe_mlp_fwd spills {spills}")
    vals = list(per.values())
    shape = " and ".join(f"{name} x [{k['n']},3] -> "
                         f"{'->'.join(map(str, k['dims']))}"
                         for name, k in per.items())
    return {
        "fused_pe_mlp": dict(
            source="cropnerf_tpu_torch/csrc/fused_pe_mlp_fwd.cu", by_net=per,
            registers=regs, spill_bytes=spills,
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:822",
            shape=f"one training step's two proposal nets: {shape}",
            ms=sum(k["ms"] for k in vals),
            ms_min=sum(k["fwd_passes"]["total"]["min"] for k in vals),
            ms_max=sum(k["fwd_passes"]["total"]["max"] for k in vals),
            call_ms=sum(k["call_ms"] for k in vals),
            plain_ms=sum(k["plain_ms"] for k in vals),
            bound_ms=sum(k["bound_ms"] for k in vals), bound_by="operations",
            rel_err=max(c["fwd_err"] for k in vals for c in k["cases"].values()),
            max_abs_err=max(c["fwd_abs"] for k in vals
                            for c in k["cases"].values())),
        "fused_pe_mlp_bwd": dict(
            source="cropnerf_tpu_torch/csrc/fused_pe_mlp_bwd.cu", by_net=per,
            registers=bwd_regs, spill_bytes=bwd_spills,
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:835",
            shape=f"their backward with dx and every weight gradient: {shape}",
            ms=sum(k["bwd_ms"] for k in vals),
            call_ms=sum(k["bwd_call_ms"] for k in vals),
            plain_ms=sum(k["bwd_plain_ms"] for k in vals),
            bound_ms=sum(k["bwd_bound_ms"] for k in vals), bound_by="operations",
            rel_err=max(c["dx_l2"] for k in vals for c in k["cases"].values()),
            max_abs_err=max(c["bwd_abs"] for k in vals
                            for c in k["cases"].values()))}


# K5's wide route (the PE variant of csrc/fused_mlp_fwd.cu; the backward
# with weight gradients csrc/fused_pe_mlp_wide_bwd.cu) by the kernel names
# the profiler records
PE_MLP_WIDE_FWD_PASSES = {"kernel": ("mlp_fwd_kernel",)}
PE_MLP_WIDE_BWD_PASSES = {"kernel": ("pe_wide_bwd_kernel",),
                          "sums": ("column_sum_kernel",)}


def pe_mlp_wide_entries(dev, card, reports, kernels) -> dict:
    """K5's wide route (pe_mlp_fwd_route "wide": the PE variant of
    csrc/fused_mlp_fwd.cu, and with weight gradients
    csrc/fused_pe_mlp_wide_bwd.cu, which keeps each block's weight sums in
    a warpgroup's registers) against the plain version at cropnerf-mxu-q's
    two 128-wide proposal nets: one training
    step's shapes (4096 rays x 256 and x 96 samples), a ragged N, N < 64,
    one row and none; the backward with dx and the weight gradients (a
    training step's: the samples carry the camera-opt graph) and with the
    weight gradients alone (positions without a graph), the latter the
    former's bits; two runs bit-identical; each call's launches exact.
    Each entry's ms, plain ms and bound are the two nets' summed, one
    training step's calls; the kernels' times are the median of
    BWD_WINDOWS profiler windows."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.proposal import proposal_init
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    cfg = PRESETS["cropnerf-mxu-q"]
    m, R = cfg.model, cfg.train_num_rays_per_batch
    g = torch.Generator(device=dev).manual_seed(14)
    names = [k.__name__ for k in kernels]

    def want(**n):
        return {k: n.get(k, 0) for k in names}

    per = {}
    for i, (p, smp) in enumerate(zip(m.proposal_fields,
                                     m.num_proposal_samples_per_ray)):
        n, F = R * smp, p.pe_freqs
        prop = proposal_init(p, torch.Generator().manual_seed(i), dev)
        wd = [t.detach() for w, b in zip(prop.mlp.w, prop.mlp.b)
              for t in (w, b.reshape(1, -1))]
        dims = [3 * (1 + 2 * F)] + [w.shape[1] for w in wd[0::2]]
        check(kf.pe_mlp_fwd_route(3, F, dims[1:]) == "wide",
              f"cropnerf-mxu-q net {i} {dims} is not on the wide route")
        x_all = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        cot_all = torch.randn((n, 1), generator=g, device=dev)

        def fwd(xb, wd=wd, F=F):
            with torch.no_grad():
                return kf.fused_pe_mlp(xb, wd, F)

        def plain_fwd(xb, wd=wd, F=F):
            with torch.no_grad():
                return kf.fused_pe_mlp_plain(xb, wd, F)

        def bwd(xb, cot, need_dx=True, wd=wd, F=F):
            dx, dw = kf.fused_pe_mlp_bwd(xb, wd, F, cot, need_dx, True)
            return ([dx] if need_dx else []) + dw

        def plain_bwd(xb, cot, wd=wd, F=F):
            leaves = [xb.clone().requires_grad_(True)] + [
                w.clone().requires_grad_(True) for w in wd]
            with torch.enable_grad():
                out = kf.fused_pe_mlp_plain(leaves[0], leaves[1:], F)
                return list(torch.autograd.grad(out, leaves, cot))

        cases = {}
        for nc in (n, n - 77, 50, 1, 0):
            xb, cot = x_all[:nc].contiguous(), cot_all[:nc].contiguous()
            res = {}
            launches = counted(kernels, lambda: res.update(
                out=fwd(xb), full=bwd(xb, cot), dw=bwd(xb, cot, False)))
            expect = want(fused_pe_mlp=1, fused_pe_mlp_bwd=2) if nc else want()
            out, got_g = res["out"], res["full"]
            check(launches == expect and out.shape == (nc, 1)
                  and got_g[0].shape == (nc, 3),
                  f"fused_pe_mlp wide net {i} N={nc}: launches "
                  f"{nonzero(launches)}, expected {nonzero(expect)}")
            if nc == 0:
                check(all(float(t.abs().sum()) == 0 for t in got_g[1:]),
                      f"fused_pe_mlp_bwd wide net {i} N=0: nonzero dW")
                cases["N=0"] = dict(launches=nonzero(launches))
                continue
            ref, ref_g = plain_fwd(xb), plain_bwd(xb, cot)
            share, l2 = row_agreement(got_g[0], ref_g[0])
            w_err, w_l2 = weight_grad_errors(got_g[1:], ref_g[1:])
            cases[f"N={nc}"] = c = dict(
                fwd_err=rel_err(out, ref), fwd_abs=abs_err(out, ref),
                rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
                bwd_abs=max(abs_err(a, b) for a, b in zip(got_g, ref_g)),
                dw_alone_same_bits=all(torch.equal(a, b) for a, b in
                                       zip(res["dw"], got_g[1:])))
            check(bool(torch.isfinite(out).all()) and c["fwd_err"] <= TOL,
                  f"fused_pe_mlp wide net {i} N={nc}: {c['fwd_err']:.2e}")
            check(share >= ROW_SHARE and l2 <= GRAD_TOL
                  and weight_grads_ok(w_err, w_l2, nc)
                  and c["dw_alone_same_bits"],
                  f"fused_pe_mlp_bwd wide net {i} N={nc}: rows {share:.4f}, "
                  f"dx L2 {l2:.2e}, weights {w_err:.2e} (L2 {w_l2:.2e}), dW "
                  f"alone the same bits {c['dw_alone_same_bits']}")
            if nc == n:
                again = bwd(xb, cot)
                c["deterministic"] = (torch.equal(out, fwd(xb)) and all(
                    torch.equal(a, b) for a, b in zip(got_g, again)))
                check(c["deterministic"], f"fused_pe_mlp wide net {i} "
                      "differs between two runs")
                del again
            del res, got_g, ref_g
        xb, cot = x_all, cot_all
        macs = mlp_macs(dims)
        hidden = macs - dims[-2] * dims[-1]
        k = dict(n=n, num_freqs=F, dims=dims, cases=cases,
                 fwd_passes=pass_ms(lambda: fwd(xb), 20,
                                    PE_MLP_WIDE_FWD_PASSES),
                 call_ms=cuda_ms(lambda: fwd(xb), 20),
                 plain_ms=device_ms(lambda: plain_fwd(xb), 5),
                 bwd_passes=pass_ms(lambda: bwd(xb, cot), 10,
                                    PE_MLP_WIDE_BWD_PASSES),
                 bwd_call_ms=cuda_ms(lambda: bwd(xb, cot), 10),
                 bwd_plain_ms=device_ms(lambda: plain_bwd(xb, cot), 5),
                 dw_only_ms=device_ms(lambda: bwd(xb, cot, False), 10,
                                      KERNEL_NS))
        k["ms"] = k["fwd_passes"]["total"]["median"]
        k["bwd_ms"] = k["bwd_passes"]["total"]["median"]
        # tensor-core products only, as the 64-wide nets' entries count them
        k["bound_ms"], k["bound_by"] = bound(2.0 * n * macs,
                                             nbytes(xb, *wd) + n * 4)
        k["bwd_bound_ms"], k["bwd_bound_by"] = bound(
            2.0 * n * (hidden + 2 * macs), nbytes(xb, cot, xb, *wd, *wd))
        per[f"net {i}"] = k
        log(f"[kernel] fused_pe_mlp wide net {i} [{n},3] -> "
            f"{'->'.join(map(str, dims))} (F={F}): err by case "
            + ", ".join(f"{c_}: fwd {v['fwd_err']:.2e}, dx rows "
                        f"{v['rows']:.5f}/L2 {v['dx_l2']:.2e}, weights "
                        f"{v['w_err']:.2e}/L2 {v['w_l2']:.2e}"
                        for c_, v in cases.items() if "rows" in v)
            + f"; forward {k['ms']:.4f} ms (call {k['call_ms']:.4f}; over "
            f"{BWD_WINDOWS} windows, median (min-max): "
            f"{fmt_passes(k['fwd_passes'])}), plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}); backward with "
            f"dx and dW {k['bwd_ms']:.4f} ms (call {k['bwd_call_ms']:.4f}; by "
            f"pass over {BWD_WINDOWS} windows, median (min-max): "
            f"{fmt_passes(k['bwd_passes'])}), dW alone "
            f"{k['dw_only_ms']:.4f} ms, plain {k['bwd_plain_ms']:.4f} ms, "
            f"bound {k['bwd_bound_ms']:.4f} ms ({k['bwd_bound_by']}); {card}")
        del x_all, cot_all
    regs = k3_names(ptxas_registers(reports["fused_mlp_fwd"]),
                    "3mlp14mlp_fwd", pe=True)
    spills = k3_names(ptxas_spills(reports["fused_mlp_fwd"]),
                      "3mlp14mlp_fwd", pe=True)
    dx_regs = k3_names(ptxas_registers(reports["fused_mlp_bwd"]),
                       "3mlp14mlp_bwd", pe=True)
    dx_spills = k3_names(ptxas_spills(reports["fused_mlp_bwd"]),
                         "3mlp14mlp_bwd", pe=True)
    bwd_regs = kernel_names(ptxas_registers(
        reports["fused_pe_mlp_wide_bwd"]), "pe_wide_bwd_kernel")
    bwd_spills = kernel_names(ptxas_spills(
        reports["fused_pe_mlp_wide_bwd"]), "pe_wide_bwd_kernel")
    # the backward's block at -q's nets: shared memory, warpgroups, sets
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    blocks = {}
    for i, k in per.items():
        lay = kmlp.mlp_layout(k["dims"][0], k["dims"][-1], len(k["dims"]) - 1,
                              k["dims"][1], True, True)
        blocks[i] = dict(smem_bytes=lay[4], compute_warpgroups=lay[5],
                         weight_gradient_warpgroups=1,
                         partial_rows=lay[6], stages=lay[7],
                         operand_sets=lay[8])
    log(f"[build] K5 wide route: fused_mlp_fwd PE variant registers {regs}, "
        f"spill bytes {spills}; fused_pe_mlp_wide_bwd (dx and dW, dW alone) "
        f"registers {bwd_regs}, spill bytes {bwd_spills}; its blocks at "
        f"cropnerf-mxu-q's nets {blocks}; dx alone on fused_mlp_bwd's PE "
        f"variant: registers {dx_regs}, spill bytes {dx_spills}")
    check(regs and bwd_regs and dx_regs
          and all(v == 0 for v in (*spills.values(), *bwd_spills.values(),
                                   *dx_spills.values()))
          and all(b["compute_warpgroups"] == 1 and b["partial_rows"] == 1
                  and b["smem_bytes"] <= 232_448 for b in blocks.values()),
          f"K5 wide route: spills {spills} {bwd_spills} {dx_spills}, "
          f"blocks {blocks}")
    vals = list(per.values())
    shape = " and ".join(f"{name} x [{k['n']},3] -> "
                         f"{'->'.join(map(str, k['dims']))}"
                         for name, k in per.items())
    cases = [c for k in vals for c in k["cases"].values() if "rows" in c]
    return {
        "fused_pe_mlp wide": dict(
            source="cropnerf_tpu_torch/csrc/fused_mlp_fwd.cu", by_net=per,
            registers=regs, spill_bytes=spills,
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:822",
            shape=f"cropnerf-mxu-q's two proposal nets at one training "
                  f"step: {shape}",
            ms=sum(k["ms"] for k in vals),
            call_ms=sum(k["call_ms"] for k in vals),
            plain_ms=sum(k["plain_ms"] for k in vals),
            bound_ms=sum(k["bound_ms"] for k in vals), bound_by="operations",
            rel_err=max(c["fwd_err"] for c in cases),
            max_abs_err=max(c["fwd_abs"] for c in cases)),
        "fused_pe_mlp_bwd wide": dict(
            source="cropnerf_tpu_torch/csrc/fused_pe_mlp_wide_bwd.cu",
            by_net=per, registers=bwd_regs, spill_bytes=bwd_spills,
            blocks=blocks,
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:835",
            shape=f"their backward with dx and every weight gradient: "
                  f"{shape}",
            ms=sum(k["bwd_ms"] for k in vals),
            call_ms=sum(k["bwd_call_ms"] for k in vals),
            plain_ms=sum(k["bwd_plain_ms"] for k in vals),
            bound_ms=sum(k["bwd_bound_ms"] for k in vals),
            bound_by="operations",
            rel_err=max(c["dx_l2"] for c in cases),
            max_abs_err=max(c["bwd_abs"] for c in cases))}


# K6 shapes: the three compositing levels of a cropnerf-mxu training step
# (4096 rays x 48, 256, 96 samples), the Pallas docstring's long axis (S up
# to 3000, volume export) and a ragged R and S
K6_SHAPES = [(4096, 48), (4096, 256), (4096, 96), (16_384, 3000), (4093, 77)]
K6_TOL = 1e-5            # max |kernel - plain| (weights lie in [0, 1])
K6_FLOPS = 8             # per sample: a product, the scan add, the exclusive
                         # difference, two negations, 1 - e, the product


def transmittance_entry(dev, card, kernels) -> dict:
    """K6 against ops/render.py render_weights at K6_SHAPES.  Its main path
    is its own entry point (no model path calls it, as none calls the
    Pallas kernel): the five calls, counts zeroed just before and read just
    after.  The entry's ms, plain ms and bound are the long axis's."""
    from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
    from cropnerf_tpu_torch.ops.render import render_weights
    g = torch.Generator(device=dev).manual_seed(14)
    inputs = []
    for R, S in K6_SHAPES:
        density = torch.rand((R, S), generator=g, device=dev) * 5
        deltas = torch.rand((R, S), generator=g, device=dev) * 0.1 * 48 / S
        inputs.append((density, deltas))
    outs = []
    with torch.no_grad():
        launches = counted(kernels, lambda: outs.extend(
            render_weights_cuda(d, dl) for d, dl in inputs))
        want = {k.__name__: 0 for k in kernels}
        want["render_weights_cuda"] = len(K6_SHAPES)
        check(launches == want, f"render_weights_cuda launches {launches}")
        per = {}
        for (R, S), (d, dl), out in zip(K6_SHAPES, inputs, outs):
            ref = render_weights(d, dl)
            err = abs_err(out, ref)
            c = dict(max_abs_err=err, rel_err=rel_err(out, ref),
                     deterministic=torch.equal(out, render_weights_cuda(d, dl)),
                     ms=device_ms(lambda: render_weights_cuda(d, dl), 20,
                                  KERNEL_NS),
                     call_ms=cuda_ms(lambda: render_weights_cuda(d, dl), 20),
                     plain_ms=device_ms(lambda: render_weights(d, dl), 10))
            c["bound_ms"] = max(nbytes(d, dl, out) / PEAK_BYTES,
                                K6_FLOPS * R * S / PEAK_F32_FLOPS) * 1e3
            check(err <= K6_TOL and c["deterministic"],
                  f"render_weights_cuda [{R},{S}]: {err:.2e}")
            per[f"[{R},{S}]"] = c
            log(f"[kernel] render_weights_cuda [{R},{S}]: err {err:.2e} (tol "
                f"{K6_TOL}); kernel {c['ms']:.4f} ms (call {c['call_ms']:.4f}),"
                f" plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                f"(bytes); {card}")
    R, S = max(K6_SHAPES, key=lambda rs: rs[1])        # the long axis
    head = per[f"[{R},{S}]"]
    return dict(
        shape=(f"density, deltas [{R},{S}] -> weights (the long axis; "
               "by_shape: a training step's three levels, a ragged shape)"),
        source="cropnerf_tpu_torch/csrc/transmittance.cu",
        replaces="cropnerf_tpu/ops/pallas/transmittance.py:36",
        launches=launches["render_weights_cuda"], by_shape=per,
        max_abs_err=max(c["max_abs_err"] for c in per.values()),
        rel_err=max(c["rel_err"] for c in per.values()),
        ms=head["ms"], call_ms=head["call_ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by="bytes")


CLOUD_RAYS = 16_384      # the CLI's rays per depth-cloud batch
CLOUD_POINTS = 1_000_000  # the CLI default's points (the reference: 10 M)


def propfused_phase(dev, card, bank, rb, cams, kernels,
                    preset: str = "cropnerf-mxu",
                    prop_hidden: int | None = None, base=None,
                    tag: str | None = None) -> tuple:
    """The fused-proposal path (K5) of ``preset`` (or of the config
    ``base``, logged under ``tag``) at full widths (with ``prop_hidden``,
    its proposal nets that wide: [prop256] and [w512], on K5's stream
    route): forward at RAYS rays and the RENDER_HW^2 render against
    the plain path (field and proposal nets on plain matmuls), 1 +
    TRAIN_STEPS training steps, each held against a plain step from its
    state (train_vs_plain), and the depth point cloud at CLOUD_RAYS rays a batch up to
    CLOUD_POINTS points (cropnerf-mxu; one batch for another preset), with
    exact launch counts for each call.
    Returns (numbers for the JSON line, calls for the trace)."""
    from cropnerf_tpu_torch.export import pointcloud as tpc
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import forward, model_init
    from cropnerf_tpu_torch.train.step import _bank_rays, make_render_fn
    full_cloud = preset == "cropnerf-mxu" and prop_hidden is None
    tag = tag or ("[propfused]" if full_cloud else "[prop256]" if prop_hidden
                  else "[mxuq] propfused")
    cfg = propfused_cfg(base or PRESETS[preset], prop_hidden)
    k5, k5b = (("fused_pe_mlp_stream", "fused_pe_mlp_stream_bwd")
               if prop_hidden else ("fused_pe_mlp", "fused_pe_mlp_bwd"))
    plain = all_plain_cfg(cfg)
    m, mp = cfg.model, plain.model
    params = model_init(m, bank.num_images, torch.Generator().manual_seed(0),
                        dev)
    render, render_p = make_render_fn(cfg), make_render_fn(plain)
    n_chunks = math.ceil(RENDER_HW ** 2 / cfg.eval_num_rays_per_chunk)
    n_prop = m.num_proposal_iterations

    def want(**counts):
        w = {k.__name__: 0 for k in kernels}
        w.update(counts)
        return w

    res, info = {}, {"card": card}
    steps = {"forward": (lambda: res.update(fwd=forward(params, rb, m)),
                         want(fused_pe_nerf=1, **{k5: n_prop})),
             "render": (lambda: res.update(img=render(params, cams, 0,
                                                      RENDER_HW, RENDER_HW)),
                        want(fused_pe_nerf=n_chunks,
                             **{k5: n_prop * n_chunks}))}
    for step, (fn, expect) in steps.items():
        launches = counted(kernels, fn)
        log(f"{tag} {step} launches: {launches}")
        check(launches == expect, f"{tag} {step} launches {launches}, "
              f"expected {expect}")
        runs = [wall_ms(fn) for _ in range(REPEATS)]
        info[step] = dict(launches=launches, runs_ms=runs,
                          median_ms=statistics.median(runs))
    fwd_p = forward(params, rb, mp)
    img_p = render_p(params, cams, 0, RENDER_HW, RENDER_HW)
    agree = {}
    for label, a, b in (("forward", res["fwd"], fwd_p),
                        ("render", res["img"], img_p)):
        for k in ("rgb", "accumulation", "semantics"):
            check(bool(torch.isfinite(a[k]).all()), f"{tag} {label} {k}")
            agree[f"{label} {k}"] = rel_err(a[k], b[k])
            if not full_cloud:
                agree[f"{label} {k} rays within"] = ray_share(a[k], b[k])
        dd = (a["depth"] - b["depth"]).abs()
        agree[f"{label} depth equal"] = (
            dd <= 1e-3 * b["depth"].abs() + 1e-4).float().mean().item()
    for k, v in agree.items():
        if k.endswith(("depth equal", "rays within")):
            check(v >= 0.99, f"{tag} {k}: {v:.4f} < 0.99")
        else:
            # cropnerf-mxu-q's 128-wide proposal nets sharpen the sample
            # weights: the kernel's and the plain version's last bits move
            # a few rays' samples (its float32 render lies 10x further
            # from JAX's than cropnerf-mxu's, with either proposal path:
            # tests/test_torch_propfused_wide.py); 99 % of its rays within
            # 2 TOL of max, every ray within 10 TOL
            limit = 2 * TOL if full_cloud else 10 * TOL
            check(v <= limit, f"{tag} {k}: {v:.3e} > {limit}")
    info["vs_plain"] = agree
    log(f"{tag} forward {RAYS} rays: median "
        f"{info['forward']['median_ms']:.2f} ms; render {RENDER_HW}x"
        f"{RENDER_HW}: median {info['render']['median_ms']:.2f} ms "
        f"({RENDER_HW ** 2 / info['render']['median_ms'] * 1e3:.0f} rays/s); "
        f"vs plain path " + ", ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; {card}")

    # training: every step of the kernel path held against a step of the
    # plain path from its state and draws
    n_steps = 1 + TRAIN_STEPS
    info["train"], run_train = train_vs_plain(cfg, plain, bank, kernels,
                                              n_steps, tag, dev)
    t = info["train"]
    per_step = want(fused_pe_nerf=1, fused_pe_nerf_bwd=1,
                    **{k5: n_prop, k5b: n_prop})
    expect = {k: n_steps * v for k, v in per_step.items()}
    log(f"{tag} launches in {n_steps} training steps: {t['launches']}")
    check(t["launches"] == expect, f"{tag} training launches "
          f"{t['launches']}, expected {expect}")
    log(f"{tag} train step at {cfg.train_num_rays_per_batch} rays: "
        f"median {t['median_ms']:.2f} ms of {TRAIN_STEPS} "
        f"({t['rays_per_s']:.0f} rays/s), runs "
        + ", ".join(f"{v:.2f}" for v in t["runs_ms"])
        + f" ms; plain path median {t['plain_median_ms']:.2f} ms; "
        f"each step from the kernel path's state vs the plain path's: "
        f"loss max rel {t['max_loss_rel']:.2e} (signed mean "
        f"{t['mean_loss_signed']:.2e}; first {t['losses'][0]:.5f} vs "
        f"{t['plain_losses'][0]:.5f}, last {t['losses'][-1]:.5f} vs "
        f"{t['plain_losses'][-1]:.5f}), gradient L2 max "
        f"{t['max_grad_l2']:.2e}, update norm max {t['max_update_norm']:.2e}"
        f", update L2 max {t['max_update_l2']:.2e} (by step: "
        + ", ".join(f"{g['grad_l2']:.2e}/{g['update_norm']:.2e}/"
                    f"{g['update_l2']:.2e}" for g in t["step_gaps"])
        + f"); losses {[round(v, 5) for v in t['losses']]}; peak "
        f"{t['peak_gib']:.2f} GiB; {card}")

    # the depth point cloud: thresholds at a first batch's medians (random
    # weights keep no ray at the CLI's 0.5), then the exporter
    gen = torch.Generator(device=dev).manual_seed(12)
    idx0 = torch.randint(0, bank.num_pixels, (CLOUD_RAYS,), generator=gen,
                         device=dev)
    with torch.no_grad():
        out0 = forward(params, _bank_rays(bank, idx0, cfg)[2], m)
    thr = dict(accumulation_threshold=out0["accumulation"].median().item(),
               semantic_threshold=out0["semantics_colormap"].median().item())
    batch = {}
    for label, mm in (("kernel", m), ("plain", mp)):
        batch[label] = tpc.depth_points(params, mm, bank, idx0, **thr)
    (pk, ck, kk), (pp, cp, kp) = batch["kernel"], batch["plain"]
    same = ((pk - pp).abs().amax(1) <= 1e-3 * pp.abs().amax(1) + 1e-4)
    cloud_agree = dict(keep_equal=(kk == kp).float().mean().item(),
                       points_equal=same.float().mean().item(),
                       colours=rel_err(ck, cp),
                       colours_rays_within=ray_share(ck, cp))
    if full_cloud:
        colours_ok = cloud_agree["colours"] <= 2 * TOL
        keep_ok = cloud_agree["keep_equal"] >= 0.99
    else:
        # cropnerf-mxu-q as its render above: 99 % of rays within 2 TOL.
        # Its accumulation saturates, so most rays lie within the last bits
        # of the median threshold, where the two paths decide apart (7-14 %
        # of the rays on the card, none in the points or colours): a keep
        # flag may flip only where the plain path's accumulation or
        # colormap lies within WIDE_FLIP of its threshold, as
        # export_vs_k3_plain holds the wide presets' flags
        colours_ok = (cloud_agree["colours_rays_within"] >= 0.99
                      and cloud_agree["colours"] <= 10 * TOL)
        with torch.no_grad():
            op = forward(params, _bank_rays(bank, idx0, cfg)[2], mp)
        near = ((op["accumulation"][..., 0]
                 - thr["accumulation_threshold"]).abs() <= WIDE_FLIP) | (
            (op["semantics_colormap"][..., 0]
             - thr["semantic_threshold"]).abs() <= WIDE_FLIP)
        cloud_agree["flips_near_threshold"] = int(((kk != kp) & near).sum())
        cloud_agree["flips_away"] = int(((kk != kp) & ~near).sum())
        keep_ok = cloud_agree["flips_away"] == 0
    check(keep_ok and cloud_agree["points_equal"] >= 0.99 and colours_ok,
          f"{tag} depth batch vs plain path {cloud_agree}")
    if not full_cloud:
        # one batch of the exporter, its launches exact
        res = {}
        launches = counted(kernels, lambda: res.update(ms=wall_ms(
            lambda: tpc.depth_points(params, m, bank, idx0, **thr))))
        expect = want(fused_pe_nerf=1, **{k5: n_prop})
        check(launches == expect, f"{tag} depth batch launches {launches}, "
              f"expected {expect}")
        runs = [wall_ms(lambda: tpc.depth_points(params, m, bank, idx0,
                                                 **thr))
                for _ in range(REPEATS)]
        info["pointcloud"] = dict(
            rays_per_batch=CLOUD_RAYS, batches=1, thresholds=thr,
            first_ms=res["ms"], runs_ms=runs,
            median_batch_ms=statistics.median(runs), launches=launches,
            kept=int(kk.sum()), first_batch_vs_plain=cloud_agree)
        log(f"{tag} depth-cloud batch of {CLOUD_RAYS} rays at thresholds "
            f"{thr}: {int(kk.sum())} points kept; first {res['ms']:.2f} ms, "
            f"median {info['pointcloud']['median_batch_ms']:.2f} ms of "
            f"{REPEATS}; launches {nonzero(launches)}; vs plain path "
            f"{cloud_agree}; {card}")
        return info, {(f"{tag} train step" if prop_hidden else
                       f"{preset} propfused train step"): run_train}
    batch_ms = []                 # each batch's device work, synchronised
    depth_points = tpc.depth_points

    def counting_batch(*a, **kw):
        out = []
        batch_ms.append(wall_ms(lambda: out.extend(depth_points(*a, **kw))))
        return tuple(out)

    cloud = {}
    tpc.depth_points = counting_batch
    try:
        t0 = time.perf_counter()
        launches = counted(kernels, lambda: cloud.update(pc=tpc.generate_point_cloud(
            params, m, bank, num_points=CLOUD_POINTS, rays_per_batch=CLOUD_RAYS,
            generator=torch.Generator(device=dev).manual_seed(12), **thr)))
        cloud_s = time.perf_counter() - t0
    finally:
        tpc.depth_points = depth_points
    nb = len(batch_ms)
    pts, cols = cloud["pc"]
    expect = want(fused_pe_nerf=nb, fused_pe_mlp=n_prop * nb)
    log(f"{tag} depth cloud launches in {nb} batches: {launches}")
    check(launches == expect, f"depth cloud launches {launches}, expected "
          f"{expect}")
    check(0 < len(pts) <= CLOUD_POINTS and bool(np.isfinite(pts).all())
          and cols.shape == pts.shape, f"depth cloud {pts.shape}")
    batches_s = sum(batch_ms) / 1e3
    info["pointcloud"] = dict(
        rays_per_batch=CLOUD_RAYS, num_points=CLOUD_POINTS, batches=nb,
        points=len(pts), thresholds=thr, seconds=cloud_s,
        batches_seconds=batches_s,
        median_batch_ms=statistics.median(batch_ms), launches=launches,
        first_batch_vs_plain=cloud_agree)
    log(f"{tag} depth cloud: {len(pts)} points (of {CLOUD_POINTS} "
        f"asked) from {nb} batches of {CLOUD_RAYS} rays at thresholds {thr}: "
        f"{cloud_s:.2f} s, of which the batches {batches_s:.2f} s (median "
        f"{statistics.median(batch_ms):.2f} ms a batch) and the host's "
        f"copies, concatenation and outlier removal the rest; first batch vs "
        f"plain path {cloud_agree}; {card}")
    trace = {"propfused train step": run_train,
             "propfused depth-cloud batch": lambda: tpc.depth_points(
                 params, m, bank, idx0, **thr)}
    return info, trace


# Each training step of the kernel path is held against one step of the
# plain path taken from the same state and draws: before the kernel step
# the plain path's parameters, optimizer moments and step count are set to
# the kernel path's and the generator's state is replayed.  Two bf16 paths
# run apart part further each step wherever the optimizer swings the loss
# (cropnerf-mxu's settings take [w1024]'s random field's loss 1.0 -> 64 ->
# 0.8, and two runs apart part by 38 % in its trough); from one state a
# step's loss, its gradient and the norm of the update it makes differ by
# that step's rounding alone, at every width (at most 2.3e-3, 4.0e-3 and
# 1.3e-4 in every phase, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6,
# [w1024]), and a wrong gradient shows in the step that takes it.
def step_gaps(kstate, pstate, before) -> dict:
    """The kernel step's gradient against the plain step's in relative L2
    over all parameters, and its update (the parameters after the step less
    ``before``): the relative gap of the updates' norms and the updates'
    relative L2 gap."""
    sums = dict(dg=0.0, g=0.0, uk=0.0, up=0.0, du=0.0)
    for (name, pk), (name_p, pp), b in zip(kstate.params.named_parameters(),
                                           pstate.params.named_parameters(),
                                           before):
        check(name == name_p and (pk.grad is None) == (pp.grad is None),
              f"parameters {name} and {name_p} of the two paths differ")
        if pk.grad is not None:
            sums["dg"] += (pk.grad - pp.grad).float().square().sum().item()
            sums["g"] += pp.grad.float().square().sum().item()
        uk, up = pk.detach() - b, pp.detach() - b
        sums["uk"] += uk.float().square().sum().item()
        sums["up"] += up.float().square().sum().item()
        sums["du"] += (uk - up).float().square().sum().item()
    r = {k: math.sqrt(v) for k, v in sums.items()}
    return dict(grad_l2=r["dg"] / max(r["g"], 1e-30),
                update_norm=abs(r["uk"] - r["up"]) / max(r["up"], 1e-30),
                update_l2=r["du"] / max(r["up"], 1e-30))


def train_vs_plain(cfg, plain, bank, kernels, n_steps, tag, dev,
                   plain_steps=None) -> tuple:
    """``n_steps`` training steps of ``cfg`` on ``bank``, and before each of
    the first ``plain_steps`` (all by default) one step of its plain path
    from the kernel path's state and draws: the kernel path's launches
    (counted over its steps alone), each such step's loss, its gradient
    (in relative L2) and the norm of its update within 2e-2 of the plain
    step's (step_gaps), the first step's loss terms within 2e-2 (or 1e-4
    absolute), wall ms of each step, the peak device memory of one more
    step.  Returns the numbers and the kernel path's step (for the
    trace)."""
    import copy
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import make_train_step
    kstate, pstate = (create_train_state(c, bank.num_images,
                                         torch.Generator().manual_seed(0), dev)
                      for c in (cfg, plain))
    kstep, pstep = make_train_step(cfg), make_train_step(plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    out, plain_out, runs, plain_runs, gaps = [], [], [], [], []
    launches = {k.__name__: 0 for k in kernels}

    def run():
        out.append(kstep(kstate, bank, gen)[1])

    for i in range(n_steps):
        compare = i < (plain_steps or n_steps)
        if compare:
            pstate.params.load_state_dict(kstate.params.state_dict())
            pstate.optimizer.load_state_dict(
                copy.deepcopy(kstate.optimizer.state_dict()))
            pstate.step = kstate.step
            before = [p.detach().clone() for p in kstate.params.parameters()]
            draws = gen.get_state()
            plain_runs.append(wall_ms(lambda: plain_out.append(
                pstep(pstate, bank, gen)[1])))
            gen.set_state(draws)
        for k, v in counted(kernels, lambda: runs.append(wall_ms(run))).items():
            launches[k] += v
        if compare:
            gaps.append(step_gaps(kstate, pstate, before))
            del before
    losses = [d["loss"].item() for d in out]
    plain_losses = [d["loss"].item() for d in plain_out]
    terms = {label: {k: v.item() for k, v in o[0].items()
                     if k.endswith("loss")}
             for label, o in (("kernel", out), ("plain", plain_out))}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    check(all(math.isfinite(v) for v in losses)
          and all(v <= 2e-2 for v in loss_rel)
          and all(g["grad_l2"] <= 2e-2 and g["update_norm"] <= 2e-2
                  for g in gaps),
          f"{tag} steps from the kernel path's state against the plain "
          f"path's: losses {losses} vs {plain_losses}, gradient, update "
          f"norm and update gaps {gaps}")
    check(all(abs(v - terms["plain"][k]) <= max(2e-2 * abs(terms["plain"][k]),
                                                  1e-4)
              for k, v in terms["kernel"].items()),
          f"{tag} first step's loss terms {terms}")
    del pstate, plain_out[:], out[:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    med = statistics.median(runs[1:])
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    return dict(launches=launches, runs_ms=runs, median_ms=med,
                first_ms=runs[0],
                rays_per_s=cfg.train_num_rays_per_batch / med * 1e3,
                plain_runs_ms=plain_runs,
                plain_median_ms=statistics.median(plain_runs[1:]
                                                  or plain_runs),
                losses=losses, plain_losses=plain_losses,
                first_terms=terms["kernel"], plain_first_terms=terms["plain"],
                max_loss_rel=max(loss_rel),
                mean_loss_signed=statistics.fmean(
                    (a - b) / abs(b) for a, b in zip(losses, plain_losses)),
                max_grad_l2=worst["grad_l2"],
                max_update_norm=worst["update_norm"],
                max_update_l2=worst["update_l2"], step_gaps=gaps,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30), run


def mxuq_phase(dev, card, bank, rb, cams, kernels) -> tuple:
    """cropnerf-mxu-q at its published widths and batch, random weights
    from a seeded generator, on the [train] bank ([mxuq] lines).  The
    published preset (its proposal nets on plain matmuls: K1 forward and
    backward, K2 and K3): forward at RAYS rays, the RENDER_HW^2 render and
    the EXPORT_SIDE^3 export with colours against the all-plain path, then
    1 + TRAIN_STEPS training steps, each held against an all-plain step
    from its state (train_vs_plain).  Then the fused-proposal variant (K1 and K5's wide
    route) through propfused_phase: forward, render, training steps and
    one depth-cloud batch.  Launches exact for each call, counts zeroed
    just before and read just after.  Returns (numbers for the JSON line,
    calls for the trace)."""
    from cropnerf_tpu_torch.export.ply import ply_vertex_count
    from cropnerf_tpu_torch.export.volume import export_and_write
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import forward, model_init
    from cropnerf_tpu_torch.train.step import make_render_fn
    cfg = PRESETS["cropnerf-mxu-q"]
    plain = all_plain_cfg(cfg)
    m, mp = cfg.model, plain.model
    names = [k.__name__ for k in kernels]

    def want(**n):
        return {k: n.get(k, 0) for k in names}

    params = model_init(m, bank.num_images, torch.Generator().manual_seed(0),
                        dev)
    render, render_p = make_render_fn(cfg), make_render_fn(plain)
    r_chunks = math.ceil(RENDER_HW ** 2 / cfg.eval_num_rays_per_chunk)
    e_chunks = -(-EXPORT_SIDE ** 2 // EXPORT_RAYS)
    aabb = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    thr = export_thresholds(params, m.field,
                            torch.Generator(device=dev).manual_seed(21), dev)
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_mxuq_"))
    kw = dict(num_points_per_side=EXPORT_SIDE, render_rgb=True, **thr)
    res, info = {}, {"card": card}
    steps = {
        "forward": (lambda: res.update(fwd=forward(params, rb, m)),
                    want(fused_pe_nerf=1)),
        "render": (lambda: res.update(img=render(params, cams, 0, RENDER_HW,
                                                 RENDER_HW)),
                   want(fused_pe_nerf=r_chunks)),
        "export": (lambda: res.update(paths=export_and_write(
            params, m, aabb, out_dir, **kw)),
                   want(fused_pe_density=e_chunks, fused_mlp=2 * e_chunks))}
    for step, (fn, expect) in steps.items():
        launches = counted(kernels, fn)
        check(launches == expect, f"[mxuq] {step} launches "
              f"{nonzero(launches)}, expected {nonzero(expect)}")
        runs = [wall_ms(fn) for _ in range(REPEATS)]
        info[step] = dict(launches=launches, runs_ms=runs,
                          median_ms=statistics.median(runs))
        log(f"[mxuq] {step}: median {info[step]['median_ms']:.2f} ms of "
            f"{REPEATS}, runs " + ", ".join(f"{v:.2f}" for v in runs)
            + f" ms; launches {nonzero(launches)}; {card}")
    agree = {}
    for label, a, b in (("forward", res["fwd"], forward(params, rb, mp)),
                        ("render", res["img"], render_p(params, cams, 0,
                                                        RENDER_HW,
                                                        RENDER_HW))):
        for k in ("rgb", "accumulation", "semantics"):
            check(bool(torch.isfinite(a[k]).all()), f"[mxuq] {label} {k}")
            agree[f"{label} {k}"] = rel_err(a[k], b[k])
        dd = (a["depth"] - b["depth"]).abs()
        agree[f"{label} depth equal"] = (
            dd <= 1e-3 * b["depth"].abs() + 1e-4).float().mean().item()
    for k, v in agree.items():
        check(v >= 0.99 if k.endswith("depth equal") else v <= 2 * TOL,
              f"[mxuq] {k}: {v:.3e}")
    points = {k: ply_vertex_count(v) for k, v in res["paths"].items()}
    plain_points = {k: ply_vertex_count(v) for k, v in export_and_write(
        params, mp, aabb, out_dir / "plain", **kw).items()}
    check(points["density"] > points["semantic"] > 0, f"[mxuq] export "
          f"points {points}")
    for k in points:
        check(abs(points[k] - plain_points[k]) <= 0.01 * plain_points[k] + 10,
              f"[mxuq] export {k}: {points[k]} points vs plain path "
              f"{plain_points[k]}")
    info["vs_plain"] = agree
    info["export"].update(points=points, plain_points=plain_points,
                          thresholds=thr)
    log(f"[mxuq] published preset vs plain path: "
        + ", ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; export {EXPORT_SIDE}^3 points {points} (plain {plain_points})"
        f"; {card}")
    shutil.rmtree(out_dir)

    n_steps = 1 + TRAIN_STEPS
    info["train"], _ = train_vs_plain(cfg, plain, bank, kernels, n_steps,
                                      "[mxuq] published", dev)
    t = info["train"]
    expect = want(fused_pe_nerf=n_steps, fused_pe_nerf_bwd=n_steps)
    check(t["launches"] == expect, f"[mxuq] training launches "
          f"{nonzero(t['launches'])}, expected {nonzero(expect)}")
    log(f"[mxuq] published train step at {cfg.train_num_rays_per_batch} "
        f"rays: median {t['median_ms']:.2f} ms of {TRAIN_STEPS} "
        f"({t['rays_per_s']:.0f} rays/s), runs "
        + ", ".join(f"{v:.2f}" for v in t["runs_ms"])
        + f" ms; plain path median {t['plain_median_ms']:.2f} ms; losses vs "
        f"plain path: max rel {t['max_loss_rel']:.2e}; launches "
        f"{nonzero(t['launches'])}; peak {t['peak_gib']:.2f} GiB; {card}")
    del params
    torch.cuda.empty_cache()
    info["propfused"], trace = propfused_phase(dev, card, bank, rb, cams,
                                               kernels, "cropnerf-mxu-q")
    return info, trace


# ---- [prop256]: 256-wide PE proposal nets and -huge's 256-wide semantic head

PROP256_HIDDEN = 256            # both proposal nets' hidden width
PROP256_SEMANTICS = 256         # -huge's semantic head's hidden width
PROP256_EXPORT_SIDE = 64
P256_PATHS = ("forward", "render", "train", "pointcloud", "huge export",
              "huge bayesrays")
P256_MAIN = {"fused_mlp_stream": "huge export",
             "fused_mlp_stream_bwd": "huge bayesrays",
             "fused_pe_mlp_stream": "train",
             "fused_pe_mlp_stream_bwd": "train"}


def prop256_phase(dev, card, bank, rb, cams, kernels, work: Path) -> tuple:
    """[prop256]: cropnerf-mxu-q with both PE proposal nets fused and
    PROP256_HIDDEN wide (3 layers, F = 5 and 6: K5's stream route) through
    propfused_phase: forward at RAYS rays, the RENDER_HW^2 render, 1 +
    TRAIN_STEPS training steps (K1 and K5 forward and backward), each held
    against a plain step from its state, one depth-cloud batch of
    CLOUD_RAYS rays.  Then K3's stream route on a model path:
    cropnerf-mxu-huge with hidden_dim_semantics PROP256_SEMANTICS (its
    semantic head [30, 256, 256, 1]), random weights from a seeded
    generator: the PROP256_EXPORT_SIDE^3 export with colours (K2 and both
    heads once a chunk: the colour head on K3's wgmma kernels, the
    semantic head on the stream route) held against the same export with
    K3's plain version and the plain path's point counts, and one
    BayesRays batch of RAYS rays on the semantics channel (K3's forward
    and dx-only backward on the stream route), its Hessian against the
    plain path's.  Launches exact, counts zeroed just before each call
    and read just after.  Returns (numbers for the JSON line, calls for
    the trace)."""
    from cropnerf_tpu_torch.models.config import PRESETS
    info, trace = propfused_phase(dev, card, bank, rb, cams, kernels,
                                  "cropnerf-mxu-q", PROP256_HIDDEN)
    cfg = PRESETS["cropnerf-mxu-huge"]
    m = dataclasses.replace(cfg.model, field=dataclasses.replace(
        cfg.model.field, hidden_dim_semantics=PROP256_SEMANTICS))
    sub, sub_trace = stream_head_paths(
        dev, card, bank, kernels, m, "[prop256] cropnerf-mxu-huge",
        "[prop256] -huge", work / "prop256_huge", 22)
    info["huge export"], info["huge bayesrays"] = sub["export"], sub["bayesrays"]
    trace.update(sub_trace)
    return info, trace


def stream_head_paths(dev, card, bank, kernels, m, tag: str, trace_tag: str,
                      out_dir: Path, seed: int, k3_route: str = "stream") -> tuple:
    """K3's stream route on a model path: the model ``m`` (a semantic head
    K3's stream route takes), random weights from a seeded generator: the
    PROP256_EXPORT_SIDE^3 export with colours (K2 and both heads once a
    chunk: the colour head on K3's wgmma kernels, the semantic head on the
    stream route) held against the same export with K3's plain version and
    the plain path's point counts, and one BayesRays batch of RAYS rays on
    the semantics channel (K2's and K3's forward and dx-only backward),
    its Hessian against the plain path's.  With ``k3_route`` "wgmma" the
    semantic head is one K3's wgmma kernels take ([w1024]'s 64-wide one),
    and both heads run there.  Launches exact, counts zeroed just before
    each call and read just after.  Returns ({"export": ..., "bayesrays":
    ...}, calls for the trace)."""
    from cropnerf_tpu_torch.export.ply import ply_vertex_count
    from cropnerf_tpu_torch.export.volume import (export_and_write,
                                                  sample_volume)
    from cropnerf_tpu_torch.models.model import model_init
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    from cropnerf_tpu_torch.uncertainty import bayesrays as br
    names = [k.__name__ for k in kernels]

    def want(**n):
        return {k: n.get(k, 0) for k in names}

    info = {}
    plain_m = dataclasses.replace(m, field=dataclasses.replace(
        m.field, mlp_impl="xla"))
    params = model_init(m, bank.num_images, torch.Generator().manual_seed(0),
                        dev)
    sem = params.field.mlp_semantic.w
    dims = [sem[0].shape[0]] + [w.shape[1] for w in sem]
    check(km.fused_mlp_route(dims[0], dims[1:]) == k3_route,
          f"{tag}'s semantic head {dims} is not on the {k3_route} route")
    stream = k3_route == "stream"
    side = PROP256_EXPORT_SIDE
    n_chunks = -(-side ** 2 // EXPORT_RAYS)
    aabb = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    thr = export_thresholds(params, m.field,
                            torch.Generator(device=dev).manual_seed(seed), dev)
    kw = dict(num_points_per_side=side, render_rgb=True, **thr)
    res = {}
    exp_want = (want(fused_pe_density=n_chunks, fused_mlp=n_chunks,
                     fused_mlp_stream=n_chunks) if stream else
                want(fused_pe_density=n_chunks, fused_mlp=2 * n_chunks))
    launches = counted(kernels, lambda: res.update(first=wall_ms(
        lambda: res.update(paths=export_and_write(params, m, aabb, out_dir,
                                                  **kw)))))
    check(launches == exp_want, f"{tag} export launches "
          f"{nonzero(launches)}, expected {nonzero(exp_want)}")
    runs = [wall_ms(lambda: export_and_write(params, m, aabb, out_dir, **kw))
            for _ in range(WIDE_REPEATS)]
    points = {k: ply_vertex_count(v) for k, v in res["paths"].items()}
    clouds = sample_volume(params, m, aabb, **kw)
    with k3_plain():
        vs = export_vs_k3_plain(clouds, sample_volume(params, m, aabb, **kw),
                                thr)
    plain_points = {k: len(c.points) for k, c in
                    sample_volume(params, plain_m, aabb, **kw).items()}
    check(points["density"] > points["semantic"] > 0,
          f"{tag} export points {points}")
    for k in points:
        check(abs(points[k] - plain_points[k]) <= 0.01 * plain_points[k] + 10,
              f"{tag} export {k}: {points[k]} points vs plain path "
              f"{plain_points[k]}")
    info["export"] = dict(side=side, chunks=n_chunks, launches=launches,
                          first_ms=res["first"], runs_ms=runs,
                          points=points, plain_points=plain_points,
                          vs_k3_plain=vs)
    log(f"{tag}, semantic head {dims}: export "
        f"{side}^3 with colours: first {res['first']:.1f} ms, runs "
        + ", ".join(f"{v:.1f}" for v in runs)
        + f" ms; launches {nonzero(launches)} ({n_chunks} chunks); points "
        f"{points} (plain path {plain_points}); against K3's plain version: "
        f"{vs}; {card}")
    del clouds

    rbs = list(br.bank_ray_batches(bank, m, 1, RAYS,
                                   torch.Generator(device=dev).manual_seed(9)))
    comp = br.ComputeUncertainty(params, m, lod=UNC_LOD, channel="semantics")
    launches = counted(kernels, lambda: res.update(
        ms=wall_ms(lambda: res.update(hess=comp.batch(rbs[0])))))
    unc_want = (want(fused_pe_density=1, fused_pe_density_bwd=1,
                     fused_mlp_stream=1, fused_mlp_stream_bwd=1) if stream else
                want(fused_pe_density=1, fused_pe_density_bwd=1,
                     fused_mlp=1, fused_mlp_bwd=1))
    check(launches == unc_want, f"{tag} BayesRays launches "
          f"{nonzero(launches)}, expected {nonzero(unc_want)}")
    hess = res["hess"]
    ref = br.ComputeUncertainty(params, plain_m, lod=UNC_LOD,
                                channel="semantics").batch(rbs[0])
    l2 = ((hess - ref).norm() / ref.norm()).item()
    hot = len(set(hess.topk(1000).indices.tolist())
              & set(ref.topk(1000).indices.tolist())) / 1000
    check(bool(torch.isfinite(hess).all()) and hess.max() > 0
          and l2 <= GRAD_TOL, f"{tag} BayesRays Hessian vs plain "
          f"path: L2 {l2:.3e}")
    runs = [wall_ms(lambda: comp.batch(rbs[0])) for _ in range(REPEATS)]
    info["bayesrays"] = dict(rays=RAYS, launches=launches,
                             first_ms=res["ms"], runs_ms=runs,
                             hessian_l2=l2, hottest_1000_shared=hot)
    log(f"{tag} BayesRays batch of {RAYS} rays "
        f"(semantics, lod {UNC_LOD}): first {res['ms']:.1f} ms, median "
        f"{statistics.median(runs):.1f} ms of {REPEATS}; Hessian vs plain "
        f"path L2 {l2:.3e}, hottest 1000 shared {hot:.3f}; launches "
        f"{nonzero(launches)}; {card}")
    trace = {f"{trace_tag} export": lambda: export_and_write(
        params, m, aabb, out_dir, **kw),
        f"{trace_tag} BayesRays batch": lambda: comp.batch(rbs[0])}
    return info, trace


# ---- [w512]: a 512-wide trunk, semantic head and PE proposal nets ---------

W512 = 512                      # the trunk's, semantic head's and nets' width
W512_PATHS = ("forward", "render", "train", "pointcloud", "export",
              "bayesrays")
# each [w512] kernel's main path
W512_MAIN = {"fused_pe_nerf": "train", "fused_pe_nerf_bwd": "train",
             "fused_pe_density": "export",
             "fused_pe_density_bwd": "bayesrays",
             "fused_mlp_stream": "export", "fused_mlp_stream_bwd": "bayesrays",
             "fused_pe_mlp_stream": "train",
             "fused_pe_mlp_stream_bwd": "train"}


def w512_cfg():
    """[w512]: cropnerf-mxu (its batch, samples and 64-wide colour head)
    with a W512-wide trunk (``field.hidden_dim``) and semantic head
    (``hidden_dim_semantics``), built with ``dataclasses.replace`` as
    benchmarks/ab_propshape.py builds its arms; ``propfused_cfg(...,
    W512)`` adds its two PE proposal nets, fused and W512 wide."""
    from cropnerf_tpu_torch.models.config import PRESETS
    cfg = PRESETS["cropnerf-mxu"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, field=dataclasses.replace(
            cfg.model.field, hidden_dim=W512, hidden_dim_semantics=W512)))


def w512_field_entries(m, dev, card, reports) -> dict:
    """K1 and K2 at [w512]'s field (wide programs, width class 1):
    wide_field_entries."""
    return wide_field_entries(m, dev, card, reports, "[w512]", 1)


def wide_field_entries(m, dev, card, reports, tag: str, wc: int) -> dict:
    """K1 and K2 at a wide field (``tag``'s, its programs of width class
    ``wc``), random weights from a seeded generator, against their plain
    versions at the path's shapes:
    K1 forward and backward at a training step's field rows (RAYS x 48
    samples), K2 forward at a 64-side export chunk (512 rays x 64) and its
    dx-only backward at a BayesRays batch (RAYS x 48, density_bwd_entry).
    K1's heads read t rounded to bf16; where the kernel's t and the plain
    version's round to neighbours the 512-wide semantic head moves that
    row's logit, so its outputs are held against the plain heads on the
    kernel's own t (heads_plain) and in relative L2 against the plain
    version.  Device ms, plain ms, bounds, registers and spills."""
    from cropnerf_tpu_torch.models.model import model_init
    from cropnerf_tpu_torch.models.vanilla import (DIR_FREQS, POS_FREQS,
                                                   fused_field_weights)
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    from cropnerf_tpu_torch.ops.posenc import nerf_encoding
    fcfg = m.field
    params = model_init(m, 8, torch.Generator().manual_seed(31), dev)
    base, top, color, sem = [[w.detach() for w in grp] for grp in
                             fused_field_weights(params.field, fcfg)]
    wd = [*base, *top, *color, *sem]
    g = torch.Generator(device=dev).manual_seed(32)
    n1, n2 = RAYS * m.num_nerf_samples_per_ray, 512 * PROP256_EXPORT_SIDE
    x = torch.rand((n1, 3), generator=g, device=dev) * 2 - 1
    d = torch.randn((n1, 3), generator=g, device=dev)
    app = params.field.appearance.mean(0).expand(n1, -1)
    ex = torch.cat([nerf_encoding(d / d.norm(dim=-1, keepdim=True),
                                  DIR_FREQS), app], -1).contiguous()
    de = ex.shape[1]
    enc_w = 3 * (1 + 2 * POS_FREQS)
    H, G = fcfg.hidden_dim, fcfg.geo_feat_dim
    trunk_macs = (mlp_macs([enc_w, H, H, H, H])
                  + mlp_macs([H + enc_w, H, H, H, 1 + G]))
    head_macs = ((G + de) * fcfg.hidden_dim_color + fcfg.hidden_dim_color * 3
                 + mlp_macs([G, fcfg.hidden_dim_semantics,
                             fcfg.num_semantic_classes]))
    meta = kf.pack_pe_field(3, POS_FREQS, base, top, color, sem, de=de,
                            device=dev)[2]
    smem = {"K1 forward": kf.smem_bytes(meta, True),
            "K1 backward": kf.bwd_smem_bytes(meta, True),
            "K2 forward": kf.smem_bytes(meta, False),
            "K2 backward": kf.bwd_smem_bytes(meta, False)}
    check(all(0 < v <= 232_448 for v in smem.values()),
          f"{tag} K1/K2 layouts {smem}")
    regs_f = short_names(ptxas_registers(reports["fused_pe_field"]))
    spills_f = short_names(ptxas_spills(reports["fused_pe_field"]))
    regs_b = short_names(ptxas_registers(reports["fused_pe_field_bwd"]))
    spills_b = short_names(ptxas_spills(reports["fused_pe_field_bwd"]))
    k1_names, k2_names = {}, {}
    out = {}
    with torch.no_grad():
        k1 = lambda: kf.fused_pe_nerf(x, ex, base, top, color, sem, POS_FREQS)  # noqa: E731
        p1 = lambda: kf.fused_pe_nerf_plain(x, ex, base, top, color, sem, POS_FREQS)  # noqa: E731
        got, ref = k1(), p1()
        on_t = kf.heads_plain(got[0], ex, color, sem)
        errs = dict(t=rel_err(got[0], ref[0]),
                    rgb_on_t=rel_err(got[1], on_t[0]),
                    sem_on_t=rel_err(got[2], on_t[1]),
                    rgb_l2=((got[1] - ref[1]).norm() / ref[1].norm()).item(),
                    sem_l2=((got[2] - ref[2]).norm() / ref[2].norm()).item(),
                    sem_vs_plain=rel_err(got[2], ref[2]))
        same = all(torch.equal(a, b) for a, b in zip(got, k1()))
        check(all(v <= TOL for k, v in errs.items() if k != "sem_vs_plain")
              and same and all(bool(torch.isfinite(o).all()) for o in got),
              f"{tag} fused_pe_nerf vs plain {errs}, deterministic {same}")
        out["fused_pe_nerf"] = dict(
            shape=f"x [{n1},3], extras [{n1},{de}] -> t [{n1},16], rgb, sem "
                  f"(trunk {H}, semantic head {fcfg.hidden_dim_semantics} "
                  f"wide)",
            source="cropnerf_tpu_torch/csrc/fused_pe_field.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:713",
            errors=errs, rel_err=max(errs["t"], errs["sem_on_t"],
                                     errs["rgb_on_t"]),
            max_abs_err=max(abs_err(a, b) for a, b in zip(got, ref)),
            deterministic=same, passes=pass_ms(k1, 10, FWD_PASSES),
            call_ms=cuda_ms(k1, 10), plain_ms=device_ms(p1, 3),
            flops=2.0 * n1 * (trunk_macs + head_macs),
            bytes=nbytes(x, ex, *wd) + nbytes(*got),
            registers=regs_f, spill_bytes=spills_f)
        del got, ref, on_t
        cots = [torch.randn((n1, c), generator=g, device=dev)
                for c in (1 + G, 3, fcfg.num_semantic_classes)]
        nb_, nt_, nc_ = len(base), len(top), len(color)

        def kb():
            dx, dex, *gs = kf.fused_pe_nerf_bwd(x, ex, base, top, color, sem,
                                                POS_FREQS, *cots, False)
            return [dx, dex] + [t for grp in gs for t in grp]

        def pb(dtype=torch.bfloat16):
            leaves = [t.clone().requires_grad_(True) for t in (x, ex, *wd)]
            ws = leaves[2:]
            with torch.enable_grad():
                outs = kf.fused_pe_nerf_plain(
                    leaves[0], leaves[1], ws[:nb_], ws[nb_:nb_ + nt_],
                    ws[nb_ + nt_:nb_ + nt_ + nc_], ws[nb_ + nt_ + nc_:],
                    POS_FREQS, dtype)
                return list(torch.autograd.grad(outs, leaves, cots))

        got_g, ref_g = kb(), pb()
        rows = [row_agreement(a, b) for a, b in zip(got_g[:2], ref_g[:2])]
        w_err, w_l2 = weight_grad_errors(got_g[2:], ref_g[2:])
        same = all(torch.equal(a, b) for a, b in zip(got_g, kb()))
        if wc == 2:
            ok, leaves = as_good_as_plain(got_g, ref_g, pb(torch.float32), 2,
                                          n1)
            log(f"{tag} fused_pe_nerf_bwd gradients at {n1} rows (dx, "
                f"dextras, then base, top, colour and semantic weights and "
                f"biases in order): L2 and max error to the bf16 plain "
                f"version, the kernel's and the bf16 plain version's L2 to "
                f"float32: " + "; ".join(" ".join(f"{v:.3e}" for v in leaf)
                                         for leaf in leaves) + f"; {card}")
        else:
            ok, leaves = (all(s_ >= ROW_SHARE and l2 <= GRAD_TOL
                              for s_, l2 in rows)
                          and weight_grads_ok(w_err, w_l2, n1)), None
        check(ok and same,
              f"{tag} fused_pe_nerf_bwd vs plain: rows {rows}, weights "
              f"{w_err:.2e} (L2 {w_l2:.2e}), each gradient's L2 and max "
              f"error to the plain version and L2 to float32 beside the "
              f"plain version's {leaves}, deterministic {same}")
        head_last = fcfg.hidden_dim_color * 3 + (
            fcfg.hidden_dim_semantics * fcfg.num_semantic_classes)
        fwd_macs = trunk_macs + head_macs
        bwd_macs = ((fwd_macs - head_last)
                    + (fwd_macs - G * fcfg.hidden_dim_semantics) + fwd_macs)
        out["fused_pe_nerf_bwd"] = dict(
            shape=f"x [{n1},3], extras [{n1},{de}], cotangents -> dx, "
                  f"dextras, every weight and bias gradient",
            source="cropnerf_tpu_torch/csrc/fused_pe_field_bwd.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:786",
            rows=rows, rel_err=w_err, weights_l2=w_l2,
            **({"leaves": leaves} if leaves else {}),
            max_abs_err=max(abs_err(a, b) for a, b in zip(got_g, ref_g)),
            deterministic=same, passes=pass_ms(kb, 5, BWD_PASSES, k1_names),
            call_ms=cuda_ms(kb, 5), plain_ms=device_ms(pb, 3),
            flops=2.0 * n1 * bwd_macs,
            bytes=nbytes(x, ex, *cots, *wd) + nbytes(x, ex, *wd),
            registers=regs_b, spill_bytes=spills_b)
        del got_g, ref_g
        x2 = x[:n2].contiguous()
        k2 = lambda: kf.fused_pe_density(x2, base, top, POS_FREQS)  # noqa: E731
        p2 = lambda: kf.fused_pe_density_plain(x2, base, top, POS_FREQS)  # noqa: E731
        got, ref = k2(), p2()
        same = torch.equal(got, k2())
        check(rel_err(got, ref) <= TOL and same,
              f"{tag} fused_pe_density vs plain {rel_err(got, ref):.2e}")
        out["fused_pe_density"] = dict(
            shape=f"x [{n2},3] -> t [{n2},16] (trunk {H} wide)",
            source="cropnerf_tpu_torch/csrc/fused_pe_field.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:328",
            rel_err=rel_err(got, ref), max_abs_err=abs_err(got, ref),
            deterministic=same, passes=pass_ms(k2, 10, FWD_PASSES),
            call_ms=cuda_ms(k2, 10), plain_ms=device_ms(p2, 3),
            flops=2.0 * n2 * trunk_macs,
            bytes=nbytes(x2, *base, *top) + nbytes(got),
            registers=regs_f, spill_bytes=spills_f)
    k2b = density_bwd_entry(base, top, trunk_macs, n1, dev, card,
                            reports["fused_pe_field_bwd"], k2_names,
                            vs_f32=wc == 2)
    k2b["replaces"] = "cropnerf_tpu/ops/pallas/fused_pe_field.py:390"
    out["fused_pe_density_bwd"] = k2b
    for name, k in out.items():
        if "passes" in k and name != "fused_pe_density_bwd":
            k["ms"] = k["passes"]["total"]["median"]
            k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        log(f"{tag} kernel {name}: {k['shape']}; err {k['rel_err']:.2e}"
            + (f" ({k['errors']})" if "errors" in k else "")
            + (f", dx/dextras rows and L2 {k['rows']}, weights L2 "
               f"{k['weights_l2']:.2e}" if "rows" in k else "")
            + f"; kernel {k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); passes {fmt_passes(k['passes'])}; registers "
            f"{k['registers']}, spill bytes {k['spill_bytes']}; {card}")
    log(f"{tag} K1/K2 dynamic shared memory per block: {smem}")
    # the wide forwards' column split (class 1) or 64-row tiles (class 2)
    # and the backward tile kernels' clusters, and their weight streams
    from cropnerf_tpu_torch.ops.cuda import pe_plan
    meta2 = kf.pack_pe_field(3, POS_FREQS, base, top, device=dev)[2]
    check(pe_plan.width_class([pe_plan.build_forward_plan(meta, True).header[
        pe_plan.H_ACT_W]]) == wc, f"{tag}'s programs are not of class {wc}")
    kn = f"pe_field_fwd_kernel<{wc}>"
    for name, mt, heads, n in (("fused_pe_nerf", meta, True, n1),
                               ("fused_pe_density", meta2, False, n2)):
        k = out[name]
        img = pe_plan.build_forward_plan(mt, heads).header[
            pe_plan.H_IMG_ELEMS] * 2
        k["cluster"] = fwd_cluster_report(
            f"{tag} {name} forward", kf.fwd_grid(mt, heads, n), n, img,
            k["ms"], k["bound_ms"], {kn: regs_f.get(kn)},
            {kn: spills_f.get(kn)}, card, 64 if wc == 2 else 128)
    for name, mt, heads, need_dw, kn, names in (
            ("fused_pe_nerf_bwd", meta, True, True,
             f"pe_field_bwd_tile_kernel<true, {wc}>", k1_names),
            ("fused_pe_density_bwd", meta2, False, False,
             f"pe_field_bwd_tile_kernel<false, {wc}>", k2_names)):
        k = out[name]
        img = pe_plan.build_plan(mt, heads, False, need_dw).header[
            pe_plan.H_IMG_ELEMS] * 2
        k["cluster"] = cluster_report(
            f"{tag} {name}{'' if need_dw else ' dx alone'}",
            kf.bwd_grid(mt, heads, need_dw, n1), n1, 2, img, k["passes"],
            k["bound_ms"], {kn: regs_b.get(kn)}, {kn: spills_b.get(kn)},
            names, card)
    return out


# the stream route at [w512]'s shapes: K3 its semantic head ([15, 512, 1]:
# a 64-side export chunk, a BayesRays batch), K5 its proposal nets (a
# training step's samples)
W512_STREAM_K3 = {"[w512] semantic head": ([15, W512, 1],
                                           512 * PROP256_EXPORT_SIDE,
                                           RAYS * 48)}
W512_STREAM_K5 = {"[w512] net 0": (5, W512, 3, RAYS * 256),
                  "[w512] net 1": (6, W512, 3, RAYS * 96)}


def w512_stream_entries(dev, card, report) -> dict:
    """The stream route's four kernels at [w512]'s nets (wide programs,
    stream_net_entry), in the kernel line's format (stream_line): K3's
    forward at the export chunk and its dx alone at the BayesRays batch,
    K5's forward and backward with dW summed over one training step's two
    nets."""
    k3 = {label: stream_net_entry(label, dims, nf, nb, None, dev, card,
                                  report)
          for label, (dims, nf, nb) in W512_STREAM_K3.items()}
    k5 = {label: stream_net_entry(label, [3 * (1 + 2 * F)] + [hw] * (
        layers - 1) + [1], n, n, F, dev, card, report)
        for label, (F, hw, layers, n) in W512_STREAM_K5.items()}
    return stream_line(k3, k5, "[w512] semantic head", list(W512_STREAM_K5),
                       "[w512]'s semantic head", "[w512]'s",
                       kernel_names_plain(ptxas_registers(report)),
                       kernel_names_plain(ptxas_spills(report)),
                       "stream (wide)")


def w512_phase(dev, card, bank, rb, cams, kernels, reports,
               work: Path) -> tuple:
    """[w512] (w512_cfg, both PE proposal nets fused and W512 wide): first
    each of its kernels at the path's shapes against its plain version
    (w512_field_entries, w512_stream_entries); then the path through
    propfused_phase: forward at RAYS rays, the RENDER_HW^2 render, 1 +
    TRAIN_STEPS training steps (K1 forward and backward with the semantic
    head inside, K5's stream route forward and backward) with every loss
    held against the plain path's, one depth-cloud batch; then
    stream_head_paths: the 64-side export (K2, K3 stream for the semantic
    head, K3 wgmma for the colour head) and one BayesRays batch (K2's and
    K3's dx-only backwards).  Launches exact, counts zeroed just before
    each call and read just after.  Returns (numbers for the JSON line,
    calls for the trace, the kernel entries with their launches on
    [w512]'s paths)."""
    entries = w512_field_entries(w512_cfg().model, dev, card, reports)
    entries.update(w512_stream_entries(dev, card, reports["fused_mlp_stream"]))
    base = w512_cfg()
    info, trace = propfused_phase(dev, card, bank, rb, cams, kernels,
                                  "cropnerf-mxu", W512, base, "[w512]")
    sub, sub_trace = stream_head_paths(dev, card, bank, kernels, base.model,
                                       "[w512]", "[w512]", work / "w512", 23)
    info.update(sub)
    trace.update(sub_trace)
    paths = {name: {path: info[path]["launches"].get(name, 0)
                    for path in W512_PATHS} for name in entries}
    log(f"[w512] launches by path: {paths}")
    check(all(paths[name][W512_MAIN[name]] > 0 for name in entries),
          f"[w512] a kernel never launched on its main path: {paths}")
    for name, k in entries.items():
        k["launches"] = paths[name][W512_MAIN[name]]
        k["launches_by_path"] = {"[w512]": paths[name]}
    info["kernels"] = {name: {key: v for key, v in k.items()
                              if key not in ("by_net", "cases")}
                       for name, k in entries.items()}
    return info, trace, entries


# ---- [w1024]: a 1024-wide trunk and mip-NeRF 360's proposal nets --------

W1024 = 1024                    # the trunk's width (mip-NeRF 360's NeRF MLP)
W1024_PROP = (256, 4)           # its PE proposal nets: width, layers
W1024_MAIN = {"fused_pe_nerf": "train", "fused_pe_nerf_bwd": "train",
              "fused_pe_density": "export",
              "fused_pe_density_bwd": "bayesrays"}


def w1024_cfg():
    """[w1024]: cropnerf-mxu (its 4096-ray batch, 256/96/48 samples, 64-wide
    colour and semantic heads) with a W1024-wide trunk
    (``field.hidden_dim``) and, as mip-NeRF 360's proposal MLPs (Barron et
    al., CVPR 2022), its two PE proposal nets W1024_PROP[1] layers, built
    with ``dataclasses.replace`` as w512_cfg; ``propfused_cfg(...,
    W1024_PROP[0])`` fuses them and makes them that wide."""
    from cropnerf_tpu_torch.models.config import PRESETS
    cfg = PRESETS["cropnerf-mxu"]
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, field=dataclasses.replace(m.field, hidden_dim=W1024),
        proposal_fields=tuple(dataclasses.replace(p, num_layers=W1024_PROP[1])
                              for p in m.proposal_fields)))


def w1024_field_entries(m, dev, card, reports) -> dict:
    """K1 and K2 at [w1024]'s field (width class 2: 64-row tiles, the
    1024-wide products in two passes): wide_field_entries."""
    return wide_field_entries(m, dev, card, reports, "[w1024]", 2)


def w1024_phase(dev, card, bank, rb, cams, kernels, reports,
                work: Path) -> tuple:
    """[w1024] (w1024_cfg, both PE proposal nets fused, W1024_PROP wide and
    deep, on K5's stream route): first K1's and K2's forward and backward
    at the path's shapes against their plain versions, with times, bounds,
    registers and spills (w1024_field_entries); then the path through
    propfused_phase: forward at RAYS rays, the RENDER_HW^2 render, 1 +
    TRAIN_STEPS training steps, each held against a plain step from its
    state (train_vs_plain), one
    depth-cloud batch; then stream_head_paths on K3's wgmma
    route (both heads 64 wide): the 64-side export (K2) and one BayesRays
    batch (K2's dx-only backward).  Launches exact, counts zeroed just
    before each call and read just after.  Returns (numbers for the JSON
    line, calls for the trace, the kernel entries with their launches on
    [w1024]'s paths)."""
    base = w1024_cfg()
    entries = w1024_field_entries(base.model, dev, card, reports)
    info, trace = propfused_phase(dev, card, bank, rb, cams, kernels,
                                  "cropnerf-mxu", W1024_PROP[0], base,
                                  "[w1024]")
    sub, sub_trace = stream_head_paths(dev, card, bank, kernels, base.model,
                                       "[w1024]", "[w1024]", work / "w1024",
                                       24, k3_route="wgmma")
    info.update(sub)
    trace.update(sub_trace)
    paths = {name: {path: info[path]["launches"].get(name, 0)
                    for path in W512_PATHS} for name in entries}
    log(f"[w1024] launches by path: {paths}")
    check(all(paths[name][W1024_MAIN[name]] > 0 for name in entries),
          f"[w1024] a kernel never launched on its main path: {paths}")
    for name, k in entries.items():
        k["launches"] = paths[name][W1024_MAIN[name]]
        k["launches_by_path"] = {"[w1024]": paths[name]}
    info["kernels"] = dict(entries)
    return info, trace, entries


# ---- the trainer loop and the CLI: the [cli] phase -----------------------

CLI_IMAGES = (32, 800, 1200)   # views, height, width: the [train] bank's shape
CLI_FOCAL = 1000.0             # pixels: a 62-degree horizontal field of view
# each preset's [cli] and [count] dataset: (views, height, width, focal).
# The cropnerf arm, whose count is printed and not held, sees the same
# scene at half the resolution (a quarter of project's rays), so that the
# script stays inside its time with the [ddp] phase
CLI_DATA = {"cropnerf-mxu": (*CLI_IMAGES, CLI_FOCAL),
            "cropnerf": (32, 400, 600, CLI_FOCAL / 2)}


def cli_data(work: Path, preset: str) -> Path:
    """The directory of ``preset``'s [cli] dataset (``work/data`` is
    cropnerf-mxu's, which the [ddp] phase trains on too)."""
    return work / ("data" if preset == "cropnerf-mxu" else f"data_{preset}")
CLI_STEPS = 500                # both presets' eval-batch and eval-image cadence
CLI_RESUME_STEPS = 20
CLI_EXPORT_SIDE = 128
CLI_UNC_ITERS = 8
CLI_UNC_LOD = 8
CLI_RENDER = ("2", "256")      # --n-frames, --size
# the terms that must fall from the first logged step to step 500.  The
# total of cropnerf-mxu is its semantic BCE, which stays near 0.5 over its
# first 500 steps (lr 1e-3) in the JAX package too
# (tools/loss_terms.py), so it is printed and not held
CLI_FALLING = {"cropnerf": ("loss", "rgb_loss"),
               "cropnerf-mxu": ("rgb_loss",)}
CLI_TERMS = ("loss", "rgb_loss", "semantics_loss", "interlevel_loss",
             "distortion_loss", "psnr")
# (centre, radius, tint, crop): two crops and a grey occluder that the
# images show and the masks leave out
CLI_SPHERES = (((0.0, 0.0, 0.0), 0.30, (0.85, 0.20, 0.10), 1),
               ((0.32, -0.22, 0.12), 0.17, (0.90, 0.60, 0.10), 1),
               ((-0.28, 0.26, -0.08), 0.21, (0.40, 0.48, 0.36), 0))


def write_cli_dataset(root: Path, n: int, height: int, width: int,
                      focal: float) -> Path:
    """A 3DCotton-layout dataset (transforms.json, images/, semantics/):
    ``n`` views on a ring around three matte spheres, ray-traced with
    numpy, on a white background; the masks cover the two crops.  Beside
    it, labels/ holds each view's instance labels from the same z-buffer:
    1 and 2 for the two crops, 0 for the background and the occluder."""
    (root / "images").mkdir(parents=True)
    (root / "semantics").mkdir()
    (root / "labels").mkdir()
    from PIL import Image
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float32),
                         np.arange(width, dtype=np.float32), indexing="ij")
    dirs_cam = np.stack([(xs + 0.5 - width / 2) / focal,
                         -(ys + 0.5 - height / 2) / focal,
                         -np.ones_like(xs)], -1)
    light = np.array([0.5, 0.5, 1.0]) / np.linalg.norm([0.5, 0.5, 1.0])
    frames = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        eye = np.array([1.2 * np.cos(theta), 1.2 * np.sin(theta),
                        (0.3, 0.55)[i % 2]])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.concatenate([np.stack([right, np.cross(right, fwd), -fwd],
                                       axis=1), eye[:, None]], axis=1)
        dirs = dirs_cam @ c2w[:, :3].T.astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        img = np.ones((height, width, 3), np.float32)
        mask = np.zeros((height, width), np.uint8)
        label = np.zeros((height, width), np.uint8)
        zbuf = np.full((height, width), np.inf, np.float32)
        for k, (ctr, rad, tint, crop) in enumerate(CLI_SPHERES):
            oc = eye - np.asarray(ctr)
            b = dirs @ oc.astype(np.float32)
            disc = b * b - (oc @ oc - rad ** 2)
            t = -b - np.sqrt(np.maximum(disc, 0))
            hit = (disc > 0) & (t > 0) & (t < zbuf)
            p = eye + t[hit][:, None] * dirs[hit]
            lam = np.clip(((p - np.asarray(ctr)) / rad) @ light, 0.2, 1.0)
            img[hit] = lam[:, None] * np.asarray(tint)
            zbuf[hit] = t[hit]
            mask[hit] = 255 * crop
            label[hit] = (k + 1) * crop
        name = f"frame_{i:04d}.png"
        Image.fromarray((img * 255).astype(np.uint8)).save(
            root / "images" / name, compress_level=1)
        Image.fromarray(mask).save(root / "semantics" / name,
                                   compress_level=1)
        Image.fromarray(label).save(root / "labels" / name,
                                    compress_level=1)
        mat = np.eye(4)
        mat[:3] = c2w
        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": mat.tolist()})
    (root / "transforms.json").write_text(json.dumps({
        "fl_x": focal, "fl_y": focal, "cx": width / 2, "cy": height / 2,
        "w": width, "h": height, "frames": frames}))
    return root


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def metrics_log(run: Path) -> list:
    return [json.loads(line) for line in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]


def cli_phase(dev, card, kernels, bare_step_ms: dict, work: Path) -> dict:
    """``python -m cropnerf_tpu_torch.cli`` in process, at full published
    widths, for ``cropnerf`` (train, resume, export, uncertainty, render)
    and ``cropnerf-mxu`` (the same with export-pointcloud in place of
    render) on a ray-traced 3DCotton-layout dataset: each command's wall
    seconds and launches (counts zeroed just before it), the loss, the
    eval metrics, the checkpoint round trip, the CLI's export against a
    direct one and the run directory's files.  ``bare_step_ms``: each
    preset's bare training-step median from its [train] phase.  The
    dataset and the run directories stay in ``work`` for the [count]
    phase."""
    import importlib.util
    from cropnerf_tpu_torch import cli
    from cropnerf_tpu_torch.data.dataparser import DataparserConfig
    from cropnerf_tpu_torch.export.ply import read_ply
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.trainer import Trainer, load_trainer_from_run
    from cropnerf_tpu_torch.export.volume import export_and_write
    for preset, (n_img, h, w, focal) in CLI_DATA.items():
        t0 = time.perf_counter()
        write_cli_dataset(cli_data(work, preset), n_img, h, w, focal)
        log(f"[cli] {preset} dataset: {n_img} views of {w}x{h}, three "
            f"spheres, written in {time.perf_counter() - t0:.1f} s")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if not have_mpl:
        log("[cli] matplotlib does not import on this machine: "
            "evaluation/vis.py cannot write the eval-image PNGs, and the "
            "port raises there as the JAX package does. So train runs "
            "through the Trainer API with the preset's steps_per_eval_image "
            "moved past the run (dataclasses.replace), then eval_image(0) "
            "without save_dir; every other command runs through cli.main")
    table = {"cropnerf": {"train": ("hash_encode", "hash_encode_bwd"),
                          "export": ("hash_encode",),
                          "uncertainty": ("hash_encode", "hash_encode_bwd"),
                          "render": ("hash_encode",)},
             "cropnerf-mxu": {"train": ("fused_pe_nerf", "fused_pe_nerf_bwd"),
                              "export": ("fused_pe_density", "fused_mlp"),
                              "uncertainty": ("fused_pe_density_bwd",
                                              "fused_mlp_bwd"),
                              "export-pointcloud": ("fused_pe_nerf",)}}
    table = {p: {**cmds, "resume": cmds["train"]} for p, cmds in table.items()}
    g = torch.Generator(device=dev).manual_seed(11)
    info = {"card": card, "dataset": CLI_DATA, "matplotlib": have_mpl}
    for preset in ("cropnerf", "cropnerf-mxu"):
        run = work / preset
        data = cli_data(work, preset)
        h, w = CLI_DATA[preset][1:3]
        cmd_s, launches, res = {}, {}, {}

        def drive(name, fn):
            t = time.perf_counter()
            launches[name] = counted(kernels, lambda: res.update({name: fn()}))
            sync(dev)
            cmd_s[name] = time.perf_counter() - t
            log(f"[cli] {preset} {name}: {cmd_s[name]:.2f} s, launches "
                + str({k: v for k, v in launches[name].items() if v}))
            return res[name]

        train_args = ["train", "--method", preset, "--data", str(data),
                      "--output", str(run)]
        if have_mpl:
            drive("train", lambda: cli.main(
                train_args + ["--max-steps", str(CLI_STEPS)]))
        else:
            def train_api():
                cfg = dataclasses.replace(
                    PRESETS[preset], steps_per_eval_image=CLI_STEPS + 1)
                trainer = Trainer(cfg, DataparserConfig(data_dir=data), run,
                                  device=dev)
                trainer.train(num_steps=CLI_STEPS)
                em = trainer.eval_image(0)
                log(f"[cli] {preset} eval_image(0) without save_dir: {em}")
                check(all(math.isfinite(v) for v in em.values()),
                      f"{preset} eval image {em}")
                return trainer
            drive("train", train_api)
        log_train = metrics_log(run)
        trained = [r for r in log_train if "train/loss" in r]
        first, last = trained[0], trained[-1]
        for r in trained:
            log(f"[cli] {preset} step {r['step']}: " + ", ".join(
                f"{k} {r['train/' + k]:.5f}" for k in CLI_TERMS))
        check(last["step"] == CLI_STEPS
              and all(last[f"train/{k}"] < first[f"train/{k}"]
                      for k in CLI_FALLING[preset]),
              f"{preset} {CLI_FALLING[preset]} at step {first['step']} -> "
              f"step {last['step']}: {first} -> {last}")
        # the held-out eval view against a training view: how far the
        # field generalises after CLI_STEPS steps
        tr = res.pop("train")
        out = tr.render(tr.state.params, tr.bank.cameras, 0, h, w)
        gt = tr.bank.rgb[:h * w].float().reshape(h, w, 3) / 255.0
        train_view_psnr = float(10 * torch.log10(
            1 / ((out["rgb"] - gt) ** 2).mean()))
        del tr, out, gt
        evals = {k: v for r in log_train for k, v in r.items()
                 if k.startswith("eval")}
        check(len(evals) > 0 and all(math.isfinite(v) for v in evals.values()),
              f"{preset} eval metrics {evals}")

        trainer = drive("resume", lambda: cli.main(
            train_args + ["--resume", "--max-steps", str(CLI_RESUME_STEPS)]))
        end = CLI_STEPS + CLI_RESUME_STEPS
        ckpt = run / "checkpoints" / f"step-{end:09d}.pt"
        check(trainer.state.step == end and ckpt.is_file(),
              f"{preset} resume: step {trainer.state.step}, {ckpt.name} "
              f"{'written' if ckpt.is_file() else 'absent'}")
        sync(dev)
        t = time.perf_counter()
        trainer.save_checkpoint()
        save_s = time.perf_counter() - t
        ckpt_mib = ckpt.stat().st_size / 2**20
        reloaded = load_trainer_from_run(run, device=dev)
        sd_a = trainer.state.params.state_dict()
        sd_b = reloaded.state.params.state_dict()
        same_params = sd_a.keys() == sd_b.keys() and all(
            torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
        opt_a = trainer.state.optimizer.state_dict()
        opt_b = reloaded.state.optimizer.state_dict()
        same_opt = len(opt_a) == len(opt_b) and all(
            a["param_groups"] == b["param_groups"]
            and a["state"].keys() == b["state"].keys()
            and all(torch.equal(v, b["state"][i][k])
                    for i in a["state"] for k, v in a["state"][i].items())
            for a, b in zip(opt_a, opt_b))
        log(f"[cli] {preset} checkpoint {ckpt.name}: {ckpt_mib:.1f} MiB, "
            f"saved in {save_s:.3f} s; reloaded step {reloaded.state.step}, "
            f"params bit for bit {same_params}, optimizer state bit for bit "
            f"{same_opt}; {card}")
        check(reloaded.state.step == end and same_params and same_opt,
              f"{preset} checkpoint round trip")

        # export thresholds from the trained field's quantiles over the box
        thr = export_thresholds(reloaded.state.params, reloaded.cfg.model.field,
                                g, dev)
        thr_args = ["--semantic-threshold", repr(thr["semantic_threshold"]),
                    "--density-threshold", repr(thr["density_threshold"]),
                    "--colormap-threshold", repr(thr["colormap_threshold"])]
        paths = drive("export", lambda: cli.main(
            ["export", "--run-dir", str(run), "--num-points-per-side",
             str(CLI_EXPORT_SIDE)] + thr_args))
        direct = export_and_write(
            reloaded.state.params, reloaded.cfg.model,
            reloaded.train_outputs.scene_box, work / f"{preset}_direct",
            dataparser_scale=2.0, num_points_per_side=CLI_EXPORT_SIDE,
            **{k: float(v) for k, v in thr.items()})
        export_points = {}
        for name, path in direct.items():
            pts, cols = read_ply(path)
            got_pts, got_cols = read_ply(paths[name])
            export_points[name] = len(got_pts)
            check(len(pts) > 0 and np.array_equal(got_pts, pts)
                  and np.array_equal(got_cols, cols),
                  f"{preset} export {name}: CLI {len(got_pts)} points vs "
                  f"direct {len(pts)}, rows equal "
                  f"{len(pts) == len(got_pts) and np.array_equal(got_pts, pts)}")
        log(f"[cli] {preset} export through the CLI: points {export_points}, "
            f"equal row for row to a direct export_and_write; thresholds "
            + ", ".join(f"{k} {v:.4g}" for k, v in thr.items()))
        del reloaded

        unc = drive("uncertainty", lambda: cli.main(
            ["uncertainty", "--run-dir", str(run), "--iters",
             str(CLI_UNC_ITERS), "--lod", str(CLI_UNC_LOD)]))
        grid = np.load(unc)
        check(grid.shape == ((2 ** CLI_UNC_LOD + 1) ** 3,)
              and bool(np.isfinite(grid).all()) and grid.max() > 0,
              f"{preset} uncertainty grid {grid.shape}")
        if preset == "cropnerf":
            out = drive("render", lambda: cli.main(
                ["render", "--run-dir", str(run), "--n-frames", CLI_RENDER[0],
                 "--size", CLI_RENDER[1], "--eval-metrics"]))
            check(Path(out).exists(), f"{preset} render wrote no {out}")
        else:
            pc = drive("export-pointcloud", lambda: cli.main(
                ["export-pointcloud", "--run-dir", str(run), "--num-points",
                 str(CLOUD_POINTS), "--rays-per-batch", str(CLOUD_RAYS)]))
            pts, _ = read_ply(pc)
            res["cloud_points"] = len(pts)
            check(bool(np.isfinite(pts).all()), f"{preset} depth cloud")
            log(f"[cli] {preset} depth cloud: {len(pts)} points")

        for cmd, names in table[preset].items():
            got = {k: launches[cmd][k] for k in names}
            check(all(v > 0 for v in got.values()),
                  f"{preset} {cmd}: a kernel of its path was not launched "
                  f"{got}")
        files = ["run_config.json", "dataparser_transforms.json",
                 "logs/metrics.jsonl", f"checkpoints/step-{CLI_STEPS:09d}.pt",
                 f"checkpoints/step-{end:09d}.pt"]
        if have_mpl:
            files += [f"eval_images/step_{CLI_STEPS:09d}/{n}.png" for n in
                      ("img", "accumulation", "depth", "semantics")]
        missing = [f for f in files if not (run / f).is_file()]
        check(not missing, f"{preset} run directory lacks {missing}")
        last_train = [r for r in metrics_log(run) if "train/loss" in r
                      and r["step"] == CLI_STEPS][0]
        rate, rate_win = (last_train["train/rays_per_s"],
                          last_train["train/rays_per_s_window"])
        bare = bare_step_ms[preset]
        R = PRESETS[preset].train_num_rays_per_batch
        log(f"[cli] {preset} loop: loss {first['train/loss']:.4f} at step "
            f"{first['step']} -> {last['train/loss']:.4f} at {CLI_STEPS}; "
            f"PSNR of training view 0 {train_view_psnr:.2f}, of the "
            f"held-out eval view {evals.get('eval_all/eval_psnr', math.nan):.2f}; "
            f"rays_per_s {rate:.0f} over the run, rays_per_s_window "
            f"{rate_win:.0f} (steps {CLI_STEPS - 100}-{CLI_STEPS}), bare "
            f"step {bare:.2f} ms = {R / bare * 1e3:.0f} rays/s ([train]); "
            f"run directory: {', '.join(files)}; {card}")
        log(f"[cli] {preset} wall s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in cmd_s.items())
            + f"; {card}")
        info[preset] = {
            "command_s": cmd_s, "launches": {
                cmd: {k: v for k, v in n.items() if v}
                for cmd, n in launches.items()},
            "loss_first": [first["step"], first["train/loss"]],
            "loss_last": [last["step"], last["train/loss"]],
            "eval": evals, "train_view_psnr": train_view_psnr,
            "rays_per_s": rate, "rays_per_s_window": rate_win,
            "bare_step_ms": bare, "bare_rays_per_s": R / bare * 1e3,
            "checkpoint_mib": ckpt_mib, "save_s": save_s,
            "export_points": export_points, "thresholds": thr,
            **({"cloud_points": res["cloud_points"]}
               if "cloud_points" in res else {})}
        res.clear()
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return info


# ---- the counting pipeline through the CLI: the [count] phase --------------

# Fixed settings of the phase, chosen once from the scene, not from the
# trained fields (PERF.md §6 gives the runs that chose them):
# - the volume export crops to the plant, the three spheres' box in the
#   dataparser frame widened by COUNT_MARGIN (ns-export's crop box; the
#   scene box also holds the hash grid's floaters near the cameras), at 256
#   samples a side with the reference's thresholds (semantic logit 3,
#   density 70, sigmoid 0.9);
# - segment's voxel of 0.01 (DBSCAN eps 0.2 = 20 voxels) joins the crops'
#   shell into one supercluster, and the crops touch; four subclusters a
#   supercluster, which the merger joins by their labels;
# - the count is held on cropnerf-mxu.  cropnerf's field on this 31-view
#   ring keeps semantic haze around the crops at 500 and at 2000 steps, in
#   its volume export and in its depth cloud alike; its subclusters gather
#   label evidence from one or two cameras of 31, and it counted 3 in five
#   of eight runs and settings (PERF.md §6).  Its chain runs all the same,
#   with every other check, and prints its count.
COUNT_EXPORT_SIDE = 256
COUNT_MARGIN = 0.1
COUNT_THRESHOLDS = (("--semantic-threshold", "3.0"),
                    ("--density-threshold", "70.0"),
                    ("--colormap-threshold", "0.9"))
COUNT_VX_SIZE = 0.01
COUNT_K = 4
COUNT_TRUTH = 2                 # the crops of CLI_SPHERES
COUNT_CHECK_CAMS = (0, 10, 20)  # kernel against plain path: subcluster 0
                                # of supercluster 0 from these cameras
# kernel against plain path: the occlusion-free image within 2/255 a pixel
# (K4 gives the plain version's bits); on the PE field a relu unit within a
# bf16 rounding of zero flips now and then (K1's and K2's tolerance), so
# there at most COUNT_WO_OCC_SHARE of a crop's pixels may lie beyond 2/255,
# none beyond COUNT_WO_OCC_CAP (measured on trained fields: up to 0.0156 %
# of a crop beyond 2/255, 0.034 at worst; PERF.md §6)
COUNT_WO_OCC_TOL = 2 / 255
COUNT_WO_OCC_SHARE = 1e-3
COUNT_WO_OCC_CAP = 0.1
COUNT_VISIBLE_SHARE = 0.005     # visible pixels that may flip (acc ~ 0.5)
COUNT_CLOUD_POINTS = 200_000    # export-pointcloud for depth-project
# the kernels a dispatch of project launches: cropnerf three hash-grid
# encodes in each pass, cropnerf-mxu the PE field once in each pass
COUNT_LAUNCHES = {"cropnerf": {"hash_encode": 6},
                  "cropnerf-mxu": {"fused_pe_nerf": 1,
                                   "fused_pe_density": 1}}
# the presets whose export, segment and project run on DDP_RANKS ranks
# under torchrun (the [ddp] phase's export --multichip and project
# --multichip) in place of one process
COUNT_RANKS = ("cropnerf",)


def plant_box(outputs) -> np.ndarray:
    """The three spheres' box in the dataparser frame of ``outputs``,
    widened by COUNT_MARGIN: [2, 3]."""
    T, s = outputs.dataparser_transform, outputs.dataparser_scale
    ends = [s * (T[:, :3] @ np.asarray(c) + T[:, 3]) + sign * r * s
            for c, r, _, _ in CLI_SPHERES for sign in (-1, 1)]
    return np.stack([np.min(ends, 0) - COUNT_MARGIN,
                     np.max(ends, 0) + COUNT_MARGIN])


def ring_text_model(directory: Path, transforms: dict) -> int:
    """A COLMAP text model (cameras.txt, images.txt) of the dataset's
    cameras: world→camera poses in OpenCV axes, one PINHOLE camera."""
    from cropnerf_tpu_torch.data.colmap import rotmat_to_qvec
    directory.mkdir(parents=True)
    t = transforms
    (directory / "cameras.txt").write_text(
        f"1 PINHOLE {t['w']} {t['h']} {t['fl_x']} {t['fl_y']} {t['cx']} "
        f"{t['cy']}\n")
    lines = []
    for i, frame in enumerate(t["frames"]):
        c2w = np.array(frame["transform_matrix"])[:3]
        c2w[:, 1:3] *= -1                      # OpenGL → OpenCV axes
        R = c2w[:, :3].T
        q, tv = rotmat_to_qvec(R), -R @ c2w[:, 3]
        lines += [f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, tv))} "
                  f"1 {Path(frame['file_path']).name}", ""]
    (directory / "images.txt").write_text("\n".join(lines) + "\n")
    return len(t["frames"])


def projection_against_plain(trainer, plain_cfg, info, dev) -> dict:
    """Supercluster 0's first subcluster from COUNT_CHECK_CAMS through the
    kernel path and the plain path, same parameters and jobs."""
    from cropnerf_tpu_torch.projection.project import ClusterProjector
    jobs = [(c, info[0]["aabb"][0]) for c in COUNT_CHECK_CAMS]
    out, secs = {}, {}
    for name, cfg in (("kernel", trainer.cfg.model), ("plain", plain_cfg)):
        proj = ClusterProjector(trainer.state.params, cfg,
                                trainer.bank.cameras, trainer.bank.height,
                                trainer.bank.width)
        t = time.perf_counter()
        out[name] = {i: (w, v) for i, w, v in proj.iter_projections(jobs)}
        secs[name] = time.perf_counter() - t
        if name == "kernel":
            plan = proj.plan(jobs)
            kernel_proj = proj
    worst_wo, worst_share, worst_beyond = 0.0, 0.0, 0.0
    skipped = {name: sorted(i for i, (w, _) in out[name].items()
                            if not w.any()) for name in out}
    for job in plan.jobs:
        (wk, vk), (wp, vp) = out["kernel"][job.index], out["plain"][job.index]
        diff = np.abs(wk - wp)
        worst_wo = max(worst_wo, float(diff.max()))
        worst_beyond = max(worst_beyond, float(
            (diff > COUNT_WO_OCC_TOL).sum()) / job.n_pix)
        worst_share = max(worst_share,
                          float(((vk > 0) != (vp > 0)).sum()) / job.n_pix)
    return dict(jobs=len(jobs), rays=plan.rays, worst_wo_occ=worst_wo,
                worst_wo_occ_share_beyond=worst_beyond,
                worst_visible_share=worst_share, skipped=skipped,
                seconds=secs, projector=kernel_proj, plan=plan)


def projection_against_one_process(trainer, info, n_cams: int, out: Path,
                                   check_dir: Path) -> tuple:
    """The PNGs of supercluster 0's subcluster 0 from COUNT_CHECK_CAMS in
    the tree ``project`` wrote on two ranks, against one process's
    ClusterProjector rendering the dispatches that hold those jobs, cut
    from the same job list as ``run_projections`` cuts it: the same rays in
    the same batches, so the same bits.  (A GEMM's result may depend on how
    many rows it multiplies, so another batching of the same jobs can move
    a pixel by one 8-bit level.)  Returns (the images that differ, the
    dispatches rendered)."""
    from cropnerf_tpu_torch.projection.project import (ClusterProjector,
                                                       _save_gray)
    jobs, want = [], {}
    for s, row in enumerate(info):
        for c in range(n_cams):
            for i in range(row["aabb"].shape[0]):
                if s == 0 and i == 0 and c in COUNT_CHECK_CAMS:
                    want[len(jobs)] = c
                jobs.append((c, row["aabb"][i]))
    proj = ClusterProjector(trainer.state.params, trainer.cfg.model,
                            trainer.bank.cameras, trainer.bank.height,
                            trainer.bank.width)
    plan = proj.plan(jobs)
    slots = {slot for slot, job in enumerate(plan.jobs) if job.index in want}
    sub = dataclasses.replace(
        plan, outside=[i for i in plan.outside if i in want],
        dispatches=[d for d in plan.dispatches
                    if any(slot in slots for slot, _, _ in d)])
    check_dir.mkdir()
    diff = []
    for idx, wo_occ, visible in proj.iter_projections(jobs, sub):
        if idx not in want:     # another job, partly in these dispatches
            continue
        c = want[idx]
        for kind, img in (("wo_occ", wo_occ), ("visible", visible)):
            mine = check_dir / f"{kind}_{c}.png"
            _save_gray(mine, img)
            tree = (out / "super_cluster_0" / f"cam_{c}"
                    / f"{kind}_cluster_0.png")
            if mine.read_bytes() != tree.read_bytes():
                diff.append(f"cam_{c}/{kind}")
    check(len(list(check_dir.iterdir())) == 2 * len(want),
          f"the one-process check rendered {sorted(check_dir.iterdir())}")
    return diff, len(sub.dispatches)


def count_phase(dev, card, kernels, work: Path) -> tuple:
    """The counting pipeline through ``python -m cropnerf_tpu_torch.cli``
    in process, on the [cli] phase's runs and dataset, for cropnerf and
    cropnerf-mxu: export (the plant's box, 256 a side, the dataparser
    frame) → segment → project (every training camera, the training
    split's instance labels) → count; cropnerf-mxu's count is held to the
    scene's two crops.  For cropnerf then render --export-cameras,
    export-pointcloud --all-points, depth-project and depth-count, and
    process-labels, rescale, segment-masks and import-colmap once each on
    the phase's own files.  Each project's launches are held exactly
    against its plan's dispatches, its kernel path against the plain path
    on one subcluster from three cameras, and its PNG tree for
    completeness.  Returns the phase's numbers and one dispatch of each
    project for the [trace] lines."""
    from cropnerf_tpu_torch import cli
    from cropnerf_tpu_torch.counting import clustering
    from cropnerf_tpu_torch.data.dataparser import (DataparserConfig,
                                                    parse_transforms)
    from cropnerf_tpu_torch.export.ply import read_ply
    from cropnerf_tpu_torch.export.volume import export_and_write
    from cropnerf_tpu_torch.native import pointcloud_ops as nat
    from cropnerf_tpu_torch.train.trainer import load_trainer_from_run

    check(nat.available(), "the native point-cloud backend is not "
          f"available: {nat.load_error()}")
    check(clustering._native() is nat,
          "the counting stage would not run on the native backend")
    log(f"[count] point-cloud backend: native ({nat.library_path().name}, "
        "built from cropnerf_tpu_torch/native/src)")
    # project indexes its labels by training camera: each label directory
    # holds its dataset's training split alone, in the split's order
    label_dirs = {}
    for preset in CLI_DATA:
        data = cli_data(work, preset)
        train = parse_transforms(DataparserConfig(data_dir=data), "train")
        label_dirs[preset] = labels = work / f"labels_train_{preset}"
        labels.mkdir()
        for p in train.image_paths:
            shutil.copy(data / "labels" / p.name, labels / f"label_{p.name}")
    n_cams = len(train.image_paths)
    box = plant_box(train)
    box_args = ["--aabb", *(repr(float(v)) for v in box.ravel())]
    thr = [a for pair in COUNT_THRESHOLDS for a in pair]
    log(f"[count] labels: {n_cams} training views of {CLI_IMAGES[0]} "
        f"(ids 1, 2 the crops; 0 the background and the occluder); export "
        f"{COUNT_EXPORT_SIDE} a side over the plant's box "
        f"{np.round(box, 4).tolist()}, "
        + ", ".join(f"{k} {v}" for k, v in COUNT_THRESHOLDS)
        + f"; segment --vx-size {COUNT_VX_SIZE} --k {COUNT_K}; truth "
        f"{COUNT_TRUTH} crops")
    info = {"card": card, "truth": COUNT_TRUTH, "backend": "native",
            "settings": {"export_side": COUNT_EXPORT_SIDE,
                         "aabb": box.tolist(),
                         "thresholds": dict(COUNT_THRESHOLDS),
                         "vx_size": COUNT_VX_SIZE, "k": COUNT_K}}
    steps = {}
    for preset in ("cropnerf", "cropnerf-mxu"):
        run = work / preset
        data, labels = cli_data(work, preset), label_dirs[preset]
        pcd = run / "count_exports"
        out = run / "projection"
        cmd_s, launches, res = {}, {}, {}

        def drive(name, argv):
            t = time.perf_counter()
            launches[name] = counted(
                kernels, lambda: res.update({name: cli.main(argv)}))
            sync(dev)
            cmd_s[name] = time.perf_counter() - t
            log(f"[count] {preset} {name}: {cmd_s[name]:.2f} s, launches "
                + str({k: v for k, v in launches[name].items() if v}))
            return res[name]

        export_argv = ["export", "--run-dir", str(run), "--output-dir",
                       str(pcd), "--num-points-per-side",
                       str(COUNT_EXPORT_SIDE), *box_args, *thr]
        segment_argv = ["segment", "--pcd-dir", str(pcd), "--k",
                        str(COUNT_K), "--vx-size", str(COUNT_VX_SIZE)]
        project_argv = ["project", "--run-dir", str(run), "--pcd-dir",
                        str(pcd), "--k", str(COUNT_K), "--label-dir",
                        str(labels), "--output-dir", str(out)]
        if preset in COUNT_RANKS:
            # export, segment (rank 0) and project on DDP_RANKS ranks
            ranks = launch_ranks({"commands": [
                {"name": "export", "argv": export_argv + ["--multichip"],
                 "ranks": "all"},
                {"name": "segment", "argv": segment_argv, "ranks": "main"},
                {"name": "project", "argv": project_argv + ["--multichip"],
                 "ranks": "all"}]}, work / f"{preset}_ranks",
                f"[count] {preset}")
            by_rank = {}
            for name in ("export", "segment", "project"):
                per = [r["commands"][name] for r in ranks]
                by_rank[name] = [nonzero(c.get("launches", {})) for c in per]
                launches[name] = {k.__name__: sum(
                    c.get("launches", {}).get(k.__name__, 0) for c in per)
                    for k in kernels}
                cmd_s[name] = per[0]["s"]
                log(f"[count] {preset} {name} on {DDP_RANKS} ranks: "
                    f"{per[0]['s']:.2f} s, launches per rank "
                    f"{by_rank[name]}")
            # run_projections' report, as rank 0 sent it back
            report = SimpleNamespace(**{
                k: ranks[0]["commands"]["project"][k]
                for k in ("plan", "render_s", "png_s")})
            log(f"[count] {preset} the torchrun call took "
                f"{ranks[0]['torchrun_s']:.1f} s; {card}")
            # the export row for row against one process's
            trainer = load_trainer_from_run(run, device=dev)
            direct = export_and_write(
                trainer.state.params, trainer.cfg.model,
                np.array([float(v) for v in box.ravel()],
                         np.float32).reshape(2, 3), work / "direct_export",
                dataparser_scale=2.0,
                num_points_per_side=COUNT_EXPORT_SIDE,
                **{k.lstrip("-").replace("-", "_"): float(v)
                   for k, v in COUNT_THRESHOLDS})
            same = {name: path.read_bytes()
                    == (pcd / f"{name}.ply").read_bytes()
                    for name, path in direct.items()}
            log(f"[count] {preset} export on {DDP_RANKS} ranks against one "
                f"process's export_and_write: files byte for byte {same}")
            check(all(same.values()), f"{preset} two-rank export differs "
                  f"from one process's: {same}")
            del trainer
        else:
            by_rank = None
            drive("export", export_argv)
            drive("segment", segment_argv)
        cloud = {name: len(read_ply(pcd / f"{name}.ply")[0])
                 for name in ("semantic", "semantic_colormap", "density")}
        sc = np.load(pcd / f"all_super_cluster_info_nsub_{COUNT_K}.npy",
                     allow_pickle=True)
        sc_points = [sum(len(p) for p in row["pcd"].values()) for row in sc]
        log(f"[count] {preset} clouds {cloud}; segment: {len(sc)} "
            f"superclusters of {sc_points} points")
        check(len(sc) > 0, f"{preset} segment found no supercluster")

        cams = range(n_cams)
        if by_rank is None:
            report = drive("project", project_argv)
        plan = report.plan
        want = {k.__name__: COUNT_LAUNCHES[preset].get(k.__name__, 0)
                * plan["dispatches"] for k in kernels}
        check(launches["project"] == want,
              f"{preset} project launched {launches['project']}, its plan "
              f"of {plan['dispatches']} dispatches asks {want}")
        if by_rank is not None:
            # rank r renders dispatches r, r + DDP_RANKS, ...
            for r, got in enumerate(by_rank["project"]):
                share = len(range(r, plan["dispatches"], DDP_RANKS))
                check(got == {k: v * share for k, v in
                              COUNT_LAUNCHES[preset].items()},
                      f"{preset} project rank {r} launched {got} for "
                      f"{share} dispatches")
        missing = [
            f"super_cluster_{s}/cam_{c}/{kind}_cluster_{i}.png"
            for s in range(len(sc)) for c in cams
            for i in range(COUNT_K) for kind in ("wo_occ", "visible")
            if not (out / f"super_cluster_{s}" / f"cam_{c}" /
                    f"{kind}_cluster_{i}.png").is_file()]
        label_counts = {len(list(d.glob("label_*.png")))
                        for d in out.glob("super_cluster_*/cam_*")}
        check(not missing and label_counts == {1}
              and len(list(out.glob("super_cluster_*/cam_*")))
              == len(sc) * len(cams),
              f"{preset} projection tree: missing {missing[:4]}, labels a "
              f"camera directory {label_counts}")
        rate = plan["rays"] / report.render_s
        log(f"[count] {preset} project: "
            f"{plan['jobs']} jobs ({plan['outside']} outside every view), "
            f"{plan['rays']} rays in {plan['dispatches']} dispatches of up "
            f"to {plan['rays_per_dispatch']}; {rate:.0f} rays/s over both "
            f"passes; render {report.render_s:.2f} s, PNG "
            f"{report.png_s:.2f} s; launches "
            f"{ {k: v for k, v in launches['project'].items() if v} } "
            f"= {COUNT_LAUNCHES[preset]} x {plan['dispatches']}; PNG tree "
            f"complete ({2 * plan['jobs']} images, one label in each of "
            f"{len(sc) * len(cams)} camera directories); {card}")

        result = drive("count", [
            "count", "--projection-dir", str(out), "--pcd-dir", str(pcd),
            "--k", str(COUNT_K), "--frame-sampling-interval", "1"])
        log(f"[count] {preset} count: total_count {result.total_count} "
            f"(truth {COUNT_TRUTH}; "
            + ("held" if preset == "cropnerf-mxu" else "printed, not held")
            + "), per supercluster "
            f"{result.per_super_cluster}, affinities "
            f"{[np.round(a, 2).tolist() for a in result.affinities[:2]]}")
        if preset == "cropnerf-mxu":
            check(result.total_count == COUNT_TRUTH,
                  f"{preset} counted {result.total_count} crops, the scene "
                  f"holds {COUNT_TRUTH}")

        trainer = load_trainer_from_run(run, device=dev)
        plain_cfg = (plain_grids(trainer.cfg) if preset == "cropnerf"
                     else all_plain_cfg(trainer.cfg)).model
        vs = projection_against_plain(trainer, plain_cfg, sc, dev)
        share = 0.0 if preset == "cropnerf" else COUNT_WO_OCC_SHARE
        cap = COUNT_WO_OCC_TOL if preset == "cropnerf" else COUNT_WO_OCC_CAP
        log(f"[count] {preset} kernel path against the plain path on "
            f"supercluster 0's subcluster 0 from cameras "
            f"{COUNT_CHECK_CAMS} ({vs['jobs']} "
            f"jobs, {vs['rays']} rays; {vs['seconds']['kernel']:.1f} s "
            f"against {vs['seconds']['plain']:.1f} s): wo_occ worst "
            f"{vs['worst_wo_occ']:.5f} (at most {cap:.5f}), beyond "
            f"{COUNT_WO_OCC_TOL:.5f} on at most "
            f"{vs['worst_wo_occ_share_beyond']:.5%} of a crop (at most "
            f"{share:.2%}), visible pixels flipped at most "
            f"{vs['worst_visible_share']:.4%} of a crop (at most "
            f"{COUNT_VISIBLE_SHARE:.1%}), jobs with zero images "
            f"{vs['skipped']}")
        proj, vplan = vs.pop("projector"), vs.pop("plan")
        check(vs["worst_wo_occ"] <= cap
              and vs["worst_wo_occ_share_beyond"] <= share
              and vs["worst_visible_share"] <= COUNT_VISIBLE_SHARE
              and vs["skipped"]["kernel"] == vs["skipped"]["plain"],
              f"{preset} project: kernel path against plain path {vs}")
        if by_rank is not None:
            diff, n_disp = projection_against_one_process(
                trainer, sc, n_cams, out, work / f"{preset}_check_png")
            log(f"[count] {preset} project on {DDP_RANKS} ranks: "
                f"supercluster 0's subcluster 0 from cameras "
                f"{COUNT_CHECK_CAMS} against one process's ClusterProjector "
                f"rendering the same {n_disp} dispatches of the same plan: "
                f"PNGs byte for byte {not diff} {diff}; {rate:.0f} rays/s "
                f"over both passes on {DDP_RANKS} ranks; {card}")
            check(not diff, f"{preset} two-rank projection differs: {diff}")
        steps[f"{preset} project dispatch"] = (
            lambda proj=proj, vplan=vplan:
            proj._render(vplan.jobs, vplan.dispatches[0]))

        entry = {"command_s": cmd_s, "launches": {
            cmd: {k: v for k, v in n.items() if v}
            for cmd, n in launches.items()}, "cloud": cloud,
            "superclusters": len(sc), "supercluster_points": sc_points,
            "plan": plan,
            "render_s": report.render_s, "png_s": report.png_s,
            "rays_per_s": rate, "total_count": result.total_count,
            "launches_by_rank": by_rank,
            "per_super_cluster": result.per_super_cluster,
            "vs_plain": vs}
        del trainer
        if preset == "cropnerf":
            entry.update(host_commands(drive, run, pcd, data, labels, work,
                                       n_cams))
        log(f"[count] {preset} wall s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in cmd_s.items())
            + f"; {card}")
        info[preset] = entry
        res.clear()
        torch.cuda.empty_cache()
    return info, steps


def host_commands(drive, run, pcd, data, labels, work, n_cams) -> dict:
    """depth-project on export-pointcloud's cloud and render
    --export-cameras' poses, depth-count, then process-labels, rescale
    --nearest, segment-masks and import-colmap once each, on the cropnerf
    arm's dataset."""
    from PIL import Image
    from cropnerf_tpu_torch.data.preprocess import (
        convert_segmentation_img_to_label)
    n_img, h, w, focal = CLI_DATA["cropnerf"]
    drive("render --export-cameras", [
        "render", "--run-dir", str(run), "--export-cameras", "--n-frames",
        "1", "--size", "64", "--output", str(work / "orbit.mp4")])
    cloud = work / "full_tree.ply"
    drive("export-pointcloud", [
        "export-pointcloud", "--run-dir", str(run), "--output", str(cloud),
        "--num-points", str(COUNT_CLOUD_POINTS), "--all-points"])
    depth = run / "depth_projection"
    drive("depth-project", [
        "depth-project", "--pcd-dir", str(pcd), "--transforms",
        str(run / "transforms_train.json"), "--full-tree", str(cloud),
        "--k", str(COUNT_K), "--output-dir", str(depth), "--height", str(h),
        "--width", str(w), "--fx", str(focal), "--fy", str(focal),
        "--cx", str(w / 2), "--cy", str(h / 2)])
    cams = sorted(depth.glob("super_cluster_*/cam_*"))
    check(len(cams) > 0 and all(len(list(d.glob("occ_free_*.png")))
                                == COUNT_K for d in cams),
          f"depth-project wrote {len(cams)} camera directories")
    label_names = sorted(labels.iterdir())
    for d in cams:      # the merger reads each camera's label beside it
        shutil.copy(label_names[int(d.name.split("_")[-1])], d)
    depth_result = drive("depth-count", [
        "depth-count", "--projection-dir", str(depth), "--pcd-dir",
        str(pcd), "--k", str(COUNT_K), "--frame-sampling-interval", "1"])
    log(f"[count] cropnerf depth-count: total_count "
        f"{depth_result.total_count} (truth {COUNT_TRUTH}; printed, not "
        f"held), per supercluster {depth_result.per_super_cluster}")

    # process-labels on instance-colour renderings of four label images
    seg = work / "seg_colour"
    seg.mkdir()
    palette = np.array([[0, 0, 0], [230, 25, 75], [60, 180, 75]], np.uint8)
    ids = {}
    for p in label_names[:4]:
        lab = np.asarray(Image.open(p))
        ids[p.name] = lab
        Image.fromarray(palette[lab]).save(seg / p.name)
    drive("process-labels", ["process-labels", "--seg-dir", str(seg),
                             "--out-dir", str(work / "seg_labels")])
    for name, lab in ids.items():
        got = np.asarray(Image.open(work / "seg_labels" / f"label_{name}"))
        ref, _ = convert_segmentation_img_to_label(palette[lab])
        check(np.array_equal(got, ref) and np.array_equal(got > 0, lab > 0),
              f"process-labels {name}")
    drive("rescale --nearest", [
        "rescale", "--src-dir", str(labels), "--dst-dir",
        str(work / "labels_half"), "--factor", "2", "--nearest"])
    half = np.asarray(Image.open(work / "labels_half" / label_names[0].name))
    full = np.asarray(Image.open(label_names[0]))
    check(half.shape == (h // 2, w // 2)
          and set(np.unique(half)) <= set(np.unique(full)),
          f"rescale --nearest: {half.shape}, ids {np.unique(half)}")
    images = work / "images_some"
    images.mkdir()
    for p in sorted((data / "images").iterdir())[:2]:
        shutil.copy(p, images)
    drive("segment-masks", ["segment-masks", "--image-dir", str(images),
                            "--out-dir", str(work / "masks"), "--k", "3"])
    masks = [np.asarray(Image.open(p)) for p in sorted((work /
                                                       "masks").iterdir())]
    check(len(masks) == 2 and all(m.shape == (h, w)
                                  and set(np.unique(m)) <= {0, 255}
                                  for m in masks),
          f"segment-masks wrote {[(m.shape, np.unique(m)) for m in masks]}")
    log(f"[count] segment-masks: foreground shares "
        f"{[float((m > 0).mean()) for m in masks]} (components over 20 % "
        f"of a frame are dropped, as the reference does)")
    meta = json.loads((data / "transforms.json").read_text())
    ring_text_model(work / "colmap", meta)
    drive("import-colmap", ["import-colmap", "--colmap-dir",
                            str(work / "colmap"), "--output",
                            str(work / "colmap_transforms.json")])
    out = json.loads((work / "colmap_transforms.json").read_text())
    centres = [np.array(f["transform_matrix"])[:3, 3] for f in out["frames"]]
    ref = [np.array(f["transform_matrix"])[:3, 3] for f in meta["frames"]]
    dist = [np.linalg.norm(a - b) for a, b in
            ((centres[i], centres[i + 1]) for i in range(len(centres) - 1))]
    dist_ref = [np.linalg.norm(a - b) for a, b in
                ((ref[i], ref[i + 1]) for i in range(len(ref) - 1))]
    check(len(out["frames"]) == n_img and np.allclose(dist, dist_ref,
                                                      atol=1e-4),
          "import-colmap: the ring's camera centres")
    return {"depth_total_count": depth_result.total_count,
            "depth_per_super_cluster": depth_result.per_super_cluster,
            "segment_mask_shares": [float((m > 0).mean()) for m in masks]}


# ---- the [ddp] phase: two ranks under torchrun ------------------------------

DDP_RANKS = 2
DDP_REPLICATED_STEPS = 5        # replicated steps before the ranks' params
DDP_TIMED = 5                   # timed steps (and all-reduces) per rank
DDP_TRAIN_STEPS = 200
DDP_TIMEOUT = 420               # seconds for one torchrun of the phase
# each rank's launches in one sharded step
DDP_LAUNCHES = {"cropnerf-mxu": {"fused_pe_nerf": 1, "fused_pe_nerf_bwd": 1},
                "cropnerf": {"hash_encode": 3, "hash_encode_bwd": 3}}
# the replay oracle's tolerances (cropnerf_tpu/train/debug.py's, camera_opt
# apart): both sides run the same kernels on the same card
DDP_ATOL, DDP_RTOL, DDP_ATOL_CAMERA_OPT = 3e-5, 1e-2, 1e-3
DDP_REPLICATED_TOL = GRAD_TOL   # relative L2 of the gradients vs one process
VIEWER_CHANNELS = ("rgb", "semantics_colormap", "depth", "accumulation",
                   "uncertainty", "instances")
VIEWER_SIZE = 256
RANK_SCRIPT = Path(__file__).resolve()   # what torchrun runs on each rank


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port, each with its launch count."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    from cropnerf_tpu_torch.ops.cuda.hash_encode import (hash_encode,
                                                         hash_encode_bwd)
    from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
    return (kf.fused_pe_nerf, kf.fused_pe_nerf_bwd, kf.fused_pe_density,
            kf.fused_pe_density_bwd, kmlp.fused_mlp, kmlp.fused_mlp_bwd,
            kmlp.fused_mlp_stream, kmlp.fused_mlp_stream_bwd, hash_encode,
            hash_encode_bwd, kf.fused_pe_mlp, kf.fused_pe_mlp_stream,
            kf.fused_pe_mlp_bwd, kf.fused_pe_mlp_stream_bwd,
            render_weights_cuda)


def rank_log(msg: str) -> None:
    """One whole line in one write: the ranks share the output."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def launch_ranks(job: dict, work: Path, what: str) -> list:
    """Run ``job`` on DDP_RANKS ranks: ``torchrun --standalone
    --nproc-per-node DDP_RANKS chip_smoke.py --rank JOB``.  Each rank
    writes its results to ``work/rank{r}.json``; the ranks' output goes to
    ``work/torchrun.log``.  A rank that fails, or a run past DDP_TIMEOUT,
    fails the phase."""
    work.mkdir(parents=True, exist_ok=True)
    job = dict(job, out=str(work))
    (work / "job.json").write_text(json.dumps(job))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DDP_RANKS), str(RANK_SCRIPT),
           "--rank", str(work / "job.json")]
    t = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=DDP_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise SystemExit(f"chip_smoke FAILED: {what} ran past "
                         f"{DDP_TIMEOUT} s:\n{(e.stdout or '')[-3000:]}")
    (work / "torchrun.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"{what}: torchrun exit {proc.returncode}:\n"
          f"{(proc.stdout + proc.stderr)[-6000:]}")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(DDP_RANKS)]
    ranks[0]["torchrun_s"] = time.perf_counter() - t
    for line in proc.stdout.splitlines():
        if line.startswith("[rank"):
            log(f"[ddp] {line}")
    return ranks


def rank_main(job_path: Path) -> None:
    """One rank under torchrun: join the group (``initialize_multihost``:
    NCCL when every rank has its own card, else gloo), run the job's
    data-parallel steps and CLI commands with the launch counts zeroed
    before each, and write what it found to ``{out}/rank{r}.json``."""
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cropnerf_tpu_torch import cli
    from cropnerf_tpu_torch.parallel.dist import (barrier,
                                                  initialize_multihost,
                                                  shutdown)
    job = json.loads(job_path.read_text())
    out = Path(job["out"])
    mesh = initialize_multihost()
    kernels = kernel_wrappers()
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device),
           "device_count": torch.cuda.device_count(), "commands": {}}
    if job.get("steps"):
        res["steps"] = ddp_rank_steps(mesh, kernels, out)
    for cmd in job.get("commands", []):
        entry = {}
        if cmd["ranks"] == "all" or mesh.is_main:
            made = {}
            t = time.perf_counter()
            entry["launches"] = counted(
                kernels, lambda: made.update(r=cli.main(cmd["argv"])))
            sync(mesh.device)
            entry["s"] = time.perf_counter() - t
            r = made["r"]
            if hasattr(r, "plan"):
                entry.update(plan=r.plan, render_s=r.render_s,
                             png_s=r.png_s)
            rank_log(f"[rank {mesh.rank}] {cmd['name']}: {entry['s']:.2f} "
                     f"s, launches {nonzero(entry['launches'])}")
        barrier(cmd["name"], mesh)
        res["commands"][cmd["name"]] = entry
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    barrier("done", mesh)
    shutdown()


def ddp_rank_steps(mesh, kernels, out: Path) -> dict:
    """A rank's part of the [ddp] checks on the [train] phase's bank: one
    sharded-bank step with its gradients for cropnerf-mxu and cropnerf
    (the shard: this rank's 16 images), then DDP_TIMED timed steps and
    all-reduces of a buffer of the gradients' size; then
    DDP_REPLICATED_STEPS replicated-bank steps of cropnerf-mxu, the first
    with its gradients.  Rank 0 saves the gradients; every rank its
    parameters after the replicated steps."""
    import torch.distributed as dist
    from cropnerf_tpu_torch.data.databank import (build_sharded_pixel_bank,
                                                  process_image_range)
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import (make_sharded_train_step,
                                               make_train_step)
    from tools.hash_bwd_real_step import synthetic_bank
    dev = mesh.device
    bank = synthetic_bank(dev)
    n, h, w = bank.num_images, bank.height, bank.width
    lo, hi = process_image_range(n, mesh)
    shard = build_sharded_pixel_bank(
        bank.rgb.view(n, h, w, 3)[lo:hi].cpu().numpy(),
        bank.mask.view(n, h, w)[lo:hi].cpu().numpy(), bank.cameras, mesh)
    res = {"images": [lo, hi], "image_offset": shard.image_offset}
    for preset in ("cropnerf-mxu", "cropnerf"):
        cfg = dataclasses.replace(PRESETS[preset],
                                  train_num_rays_per_batch=RAYS)
        state = create_train_state(cfg, n, torch.Generator().manual_seed(0),
                                   dev)
        step = make_sharded_train_step(cfg, mesh, return_grads=True)
        gen = torch.Generator(device=dev).manual_seed(5)
        m = {}
        launches = counted(kernels, lambda: m.update(
            step(state, shard, gen)[1]))
        if mesh.is_main:
            torch.save({"grads": {k: v.cpu() for k, v in m["grads"].items()},
                        **{k: float(v) for k, v in m.items() if k != "grads"}},
                       out / f"sharded_{preset}.pt")
        step = make_sharded_train_step(cfg, mesh)
        runs = []
        for _ in range(DDP_TIMED):
            sync(dev)
            t = time.perf_counter()
            step(state, shard, gen)
            sync(dev)
            runs.append((time.perf_counter() - t) * 1e3)
        numel = sum(p.numel() for p in state.params.parameters()) + 7
        buf = torch.zeros(numel, device=dev)
        ar = []
        for _ in range(DDP_TIMED):
            sync(dev)
            t = time.perf_counter()
            dist.all_reduce(buf, group=mesh.group)
            sync(dev)
            ar.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(runs)
        res[preset] = {"launches": nonzero(launches), "step_ms": med,
                       "runs_ms": runs, "rays_per_s": RAYS / med * 1e3,
                       "allreduce_ms": statistics.median(ar),
                       "allreduce_runs_ms": ar, "buffer_floats": numel,
                       "loss": float(m["loss"])}
        rank_log(f"[rank {mesh.rank}] {preset} sharded step: launches "
                 f"{nonzero(launches)}, median {med:.2f} ms "
                 f"({RAYS / med * 1e3:.0f} rays/s over both ranks), "
                 f"all-reduce of {numel} floats "
                 f"{statistics.median(ar):.2f} ms")
        del state, step, buf
    cfg = dataclasses.replace(PRESETS["cropnerf-mxu"],
                              train_num_rays_per_batch=RAYS)
    state = create_train_state(cfg, n, torch.Generator().manual_seed(0), dev)
    step = make_train_step(cfg, mesh=mesh, return_grads=True)
    gen = torch.Generator(device=dev).manual_seed(6)
    m = {}
    launches = counted(kernels, lambda: m.update(step(state, bank, gen)[1]))
    if mesh.is_main:
        torch.save({"grads": {k: v.cpu() for k, v in m["grads"].items()},
                    **{k: float(v) for k, v in m.items() if k != "grads"}},
                   out / "replicated.pt")
    for _ in range(DDP_REPLICATED_STEPS - 1):
        step(state, bank, gen)
    torch.save({k: v.cpu() for k, v in state.params.state_dict().items()},
               out / f"replicated_params_rank{mesh.rank}.pt")
    res["replicated"] = {"launches": nonzero(launches),
                         "loss": float(m["loss"])}
    return res


def ddp_phase(dev, card, bank, work: Path) -> dict:
    """The [ddp] lines: two ranks under torchrun (NCCL on two cards, gloo
    when they share one): the sharded-bank step of cropnerf-mxu (K1) and
    cropnerf (K4) at full widths against the replay oracle run here on the
    same card, the replicated-bank step against the one-process step on the
    same draws and the ranks' parameters after DDP_REPLICATED_STEPS steps,
    then ``train --multichip --shard-bank on`` (cropnerf-mxu,
    DDP_TRAIN_STEPS steps) on the [cli] dataset."""
    from cropnerf_tpu_torch.data.databank import padded_num_images
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.debug import (assert_grads_match,
                                                replay_sharded_step)
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import make_train_step
    from cropnerf_tpu_torch.train.trainer import load_trainer_from_run
    n_cards = torch.cuda.device_count()
    run = work / "ddp_run"
    train_argv = ["train", "--method", "cropnerf-mxu", "--data",
                  str(work / "data"), "--output", str(run), "--max-steps",
                  str(DDP_TRAIN_STEPS), "--rays-per-batch", str(RAYS),
                  "--multichip", "--shard-bank", "on"]
    log(f"[ddp] {n_cards} card(s) visible; {DDP_RANKS} ranks "
        + ("over NCCL, one card each" if n_cards >= DDP_RANKS else
           "sharing one card over gloo (NCCL refuses two ranks on one "
           "card): the numbers below say nothing about scaling"))
    ranks = launch_ranks({"steps": True, "commands": [
        {"name": "train", "argv": train_argv, "ranks": "all"}]},
        work / "ddp_job", "[ddp]")
    backends = {r["backend"] for r in ranks}
    log(f"[ddp] torch.cuda.device_count() {n_cards}; backend "
        f"{sorted(backends)}; ranks on {[r['device'] for r in ranks]}; "
        f"the torchrun call took {ranks[0]['torchrun_s']:.1f} s")
    want_backend = "nccl" if n_cards >= DDP_RANKS else "gloo"
    check(backends == {want_backend},
          f"[ddp] backend {backends}, expected {want_backend}")
    info = {"card": card, "device_count": n_cards, "backend": want_backend,
            "ranks": DDP_RANKS, "torchrun_s": ranks[0]["torchrun_s"]}
    out = work / "ddp_job"

    # 1. the sharded-bank step against the replay oracle
    n = bank.num_images
    for preset in ("cropnerf-mxu", "cropnerf"):
        cfg = dataclasses.replace(PRESETS[preset],
                                  train_num_rays_per_batch=RAYS)
        state = create_train_state(cfg, n, torch.Generator().manual_seed(0),
                                   dev)
        ref = replay_sharded_step(state, bank,
                                   torch.Generator(device=dev).manual_seed(5),
                                   cfg, DDP_RANKS)
        got = torch.load(out / f"sharded_{preset}.pt")
        got["grads"] = {k: v.to(dev) for k, v in got["grads"].items()}
        worst = assert_grads_match(got, ref, DDP_ATOL, DDP_RTOL,
                                   DDP_ATOL_CAMERA_OPT)
        per_rank = [r["steps"][preset] for r in ranks]
        log(f"[ddp] {preset} sharded step ({RAYS} rays, {RAYS // DDP_RANKS} "
            f"a rank) against replay_sharded_step on this card: loss "
            f"{got['loss']:.6f} vs {float(ref['loss']):.6f}; largest "
            "gradient deviation per leaf group "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f" (atol {DDP_ATOL}, rtol {DDP_RTOL}, camera_opt "
            f"{DDP_ATOL_CAMERA_OPT}); launches per rank "
            f"{[p['launches'] for p in per_rank]}")
        for r, p in enumerate(per_rank):
            check(p["launches"] == DDP_LAUNCHES[preset],
                  f"[ddp] {preset} rank {r} launched {p['launches']}, one "
                  f"sharded step launches {DDP_LAUNCHES[preset]}")
            log(f"[ddp] {preset} rank {r}: step median {p['step_ms']:.2f} "
                f"ms of {DDP_TIMED} ({p['rays_per_s']:.0f} rays/s, the "
                f"global batch), all-reduce of {p['buffer_floats']} floats "
                f"median {p['allreduce_ms']:.2f} ms; {card}")
        info[preset] = {"worst_by_group": worst, "loss": got["loss"],
                        "replay_loss": float(ref["loss"]),
                        "ranks": per_rank}
        del state, ref, got

    # 2. the replicated-bank step against the one-process step
    cfg = dataclasses.replace(PRESETS["cropnerf-mxu"],
                              train_num_rays_per_batch=RAYS)
    state = create_train_state(cfg, n, torch.Generator().manual_seed(0), dev)
    _, ref = make_train_step(cfg, return_grads=True)(
        state, bank, torch.Generator(device=dev).manual_seed(6))
    got = torch.load(out / "replicated.pt")
    l2 = {k: float(torch.linalg.vector_norm(got["grads"][k].to(dev) - g)
                   / max(float(torch.linalg.vector_norm(g)), 1e-30))
          for k, g in ref["grads"].items()}
    worst = max(l2, key=l2.get)
    p = [torch.load(out / f"replicated_params_rank{r}.pt")
         for r in range(DDP_RANKS)]
    same = all(torch.equal(p[0][k], q[k]) for q in p[1:] for k in p[0])
    loss_rel = abs(got["loss"] - float(ref["loss"])) / abs(float(ref["loss"]))
    log(f"[ddp] cropnerf-mxu replicated-bank step vs the one-process step "
        f"on the same draws: loss {got['loss']:.6f} vs "
        f"{float(ref['loss']):.6f} (rel {loss_rel:.2e}); gradient relative "
        f"L2 worst {worst} {l2[worst]:.2e} (at most {DDP_REPLICATED_TOL}); "
        f"ranks' parameters after {DDP_REPLICATED_STEPS} steps bit for bit "
        f"{same}; launches per rank "
        f"{[r['steps']['replicated']['launches'] for r in ranks]}")
    check(loss_rel <= 1e-3 and l2[worst] <= DDP_REPLICATED_TOL and same,
          "[ddp] replicated-bank step against the one-process step")
    info["replicated"] = {"loss": got["loss"], "one_process_loss":
                          float(ref["loss"]), "loss_rel": loss_rel,
                          "grad_rel_l2_worst": [worst, l2[worst]],
                          "params_bitwise": same}
    del state, ref, got, p

    # 3. train --multichip --shard-bank on through torchrun
    cmds = [r["commands"]["train"] for r in ranks]
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    meta = json.loads((run / "run_config.json").read_text())
    trained = {r["step"]: r for r in metrics_log(run) if "train/loss" in r}
    n_train = meta["num_train_images"]
    trainer = load_trainer_from_run(run, device=dev)
    want_n = padded_num_images(len(trainer.train_outputs.image_paths),
                               DDP_RANKS)
    rgb = {s: trained[s]["train/rgb_loss"] for s in (100, DDP_TRAIN_STEPS)}
    log(f"[ddp] train --multichip --shard-bank on, cropnerf-mxu, "
        f"{DDP_TRAIN_STEPS} steps on the [cli] dataset: wall s per rank "
        f"{[round(c['s'], 2) for c in cmds]}; launches per rank "
        f"{[nonzero(c['launches']) for c in cmds]}; checkpoints {ckpts}, "
        f"loaded at step {trainer.state.step}; run_config shard_bank "
        f"{meta['shard_bank']}, num_train_images {n_train} (padded from "
        f"{len(trainer.train_outputs.image_paths)}); rgb_loss step 100 "
        f"{rgb[100]:.5f} -> step {DDP_TRAIN_STEPS} "
        f"{rgb[DDP_TRAIN_STEPS]:.5f}; {card}")
    check(ckpts == [f"step-{DDP_TRAIN_STEPS:09d}.pt"]
          and trainer.state.step == DDP_TRAIN_STEPS
          and meta["shard_bank"] is True and n_train == want_n
          and rgb[DDP_TRAIN_STEPS] < rgb[100],
          "[ddp] train --multichip: checkpoints, run_config or loss")
    for r, c in enumerate(cmds):
        check(c["launches"]["fused_pe_nerf_bwd"] == DDP_TRAIN_STEPS
              and c["launches"]["fused_pe_nerf"] >= DDP_TRAIN_STEPS,
              f"[ddp] train rank {r} launched {nonzero(c['launches'])}")
    del trainer
    info["train"] = {"wall_s": [c["s"] for c in cmds],
                     "launches": [nonzero(c["launches"]) for c in cmds],
                     "rgb_loss": rgb, "checkpoints": ckpts,
                     "num_train_images": n_train}
    info["launches"] = {
        **{f"{preset} sharded step rank {r}": ranks[r]["steps"][preset][
            "launches"] for preset in ("cropnerf-mxu", "cropnerf")
           for r in range(DDP_RANKS)},
        **{f"cropnerf-mxu replicated step rank {r}":
           ranks[r]["steps"]["replicated"]["launches"]
           for r in range(DDP_RANKS)},
        **{f"train rank {r}": nonzero(cmds[r]["launches"])
           for r in range(DDP_RANKS)}}
    return info


def viewer_phase(card, run: Path, pcd: Path) -> dict:
    """The ``viewer`` command's server (``cli.make_viewer`` on its parsed
    arguments) on the cropnerf-mxu run, serving in the background (its
    BayesRays grid, the counted instances and the cluster boxes as
    overlays): the page, one /render per channel, each a PNG of the asked
    size, timed after a first request, and a 404; then the server stops."""
    import urllib.error
    import urllib.request
    from PIL import Image
    from cropnerf_tpu_torch import cli
    argv = ["viewer", "--run-dir", str(run), "--port", "0", "--size",
            str(VIEWER_SIZE), "--uncertainty", str(run / "unc.npy"),
            "--uncertainty-lod", str(CLI_UNC_LOD), "--instances-ply",
            str(pcd / "full_tree_seg_result.ply"), "--pcd-dir", str(pcd),
            "--k", str(COUNT_K)]
    t0 = time.perf_counter()
    server = cli.make_viewer(cli.build_parser().parse_args(argv))
    server.start_background()
    start_s = time.perf_counter() - t0
    times = {}
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            check(r.status == 200 and b"cropnerf viewer" in r.read(),
                  "[viewer] GET / did not return the page")
        for channel in VIEWER_CHANNELS:
            url = (f"{base}/render?theta=0.5&phi=0.35&r=1.3&f=1"
                   f"&channel={channel}")
            for _ in range(2):     # the first request warms the path
                t = time.perf_counter()
                with urllib.request.urlopen(url, timeout=120) as r:
                    body = r.read()
                    kind = r.headers["Content-Type"]
                ms = (time.perf_counter() - t) * 1e3
            img = Image.open(io.BytesIO(body))
            check(kind == "image/png" and img.size == (VIEWER_SIZE,
                                                       VIEWER_SIZE),
                  f"[viewer] {channel}: {kind} {img.size}")
            times[channel] = ms
        try:
            urllib.request.urlopen(base + "/nothing", timeout=60)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
        check(missing == 404, f"[viewer] an unknown path gave {missing}")
    finally:
        server.shutdown()
    log(f"[viewer] viewer --run-dir <cropnerf-mxu run> --uncertainty "
        f"--instances-ply --pcd-dir: serving after {start_s:.1f} s; "
        f"{VIEWER_SIZE}x{VIEWER_SIZE} PNG per channel, ms per request "
        "after a first: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      times.items())
        + f"; / the page, an unknown path 404; stopped; {card}")
    return {"card": card, "start_s": start_s, "size": VIEWER_SIZE,
            "render_ms": times}


# ---- rematerialisation: the presets that keep it on ([remat]) --------------

# the presets whose ModelConfig keeps remat on, at their published batches
REMAT_PRESETS = ("cropnerf-big", "cropnerf-huge", "semantic-nerf")
# K4 launches of one proposal-update step, (forward, backward), with remat
# on and off: each hash encode launches once forward, once more in its
# replay under remat, and once backward (semantic-nerf's field is a PE
# field on plain matmuls, so only its two proposal nets encode)
REMAT_K4 = {"cropnerf-big": {True: (6, 3), False: (3, 3)},
            "cropnerf-huge": {True: (6, 3), False: (3, 3)},
            "semantic-nerf": {True: (4, 2), False: (2, 2)},
            "cropnerf": {True: (6, 3), False: (3, 3)}}
# remat-off gradients taken from the same state and draws: their pairwise
# deviation is each leaf's noise floor (K4 backward's atomics).  A leaf's
# largest deviation is an extreme of that rounding noise, and the one of
# remat on against off is a draw of the same extreme as the off runs' own
# (one H100 run saw 3.331e-16 against 2.776e-16 on a proposal grid), so it
# is held to REMAT_NOISE times the floor; what makes the check exact is
# that every K4 backward receives the same bits with remat on and off
REMAT_OFF_RUNS = 3
REMAT_NOISE = 2.0
REMAT_TIMED = 5                 # timed steps each way, after a first
REMAT_CROPNERF_RAYS = 32_768    # cropnerf (remat off) with --remat on and off
REMAT_CLI_STEPS = 50
WATCHDOG_STEPS, WATCHDOG_LOG = 40, 5


def with_remat(cfg, on: bool):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              remat=on))


def leaf_group(name: str) -> str:
    """A parameter's group: its first two name parts (field.grid,
    field.mlp_base, proposal_0.grid, camera_opt, ...)."""
    return ".".join(name.split(".")[:2])


def remat_gradient(state, cfg, bank, dev):
    """(loss, gradients by name, K4 backward's inputs) of one training
    batch of ``cfg`` on ``state``'s parameters, from a generator seeded
    alike every time; the parameters and the optimizer stay as they are.
    The inputs are each hash_encode_bwd call's level layout, positions and
    cotangent, copied, in the order of the calls."""
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    from cropnerf_tpu_torch.train.step import train_loss
    gen = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, bank.num_pixels, (cfg.train_num_rays_per_batch,),
                        generator=gen, device=dev)
    inputs, bwd = [], kh.hash_encode_bwd

    def capture(table2d, pos, grad, *layout, **kw):
        inputs.append((layout, pos.clone(), grad.clone()))
        # the kernel counts its launches on the module's hash_encode_bwd
        kh.hash_encode_bwd = bwd
        try:
            return bwd(table2d, pos, grad, *layout, **kw)
        finally:
            kh.hash_encode_bwd = capture

    state.optimizer.zero_grad(set_to_none=True)
    kh.hash_encode_bwd = capture
    try:
        loss, _ = train_loss(state.params, bank, idx, state.step, cfg, gen)
        loss.backward()
    finally:
        kh.hash_encode_bwd = bwd
    grads = {k: p.grad.detach().clone()
             for k, p in state.params.named_parameters()
             if p.grad is not None}
    state.optimizer.zero_grad(set_to_none=True)
    return loss.detach(), grads, inputs


def remat_bayesrays(params, cfg, bank, kernels, dev, card) -> dict:
    """One BayesRays batch (RAYS rays, lod UNC_LOD) of ``cfg`` with remat
    on and twice off.  The Hessian pass samples without a graph and
    differentiates field_density, outside the checkpointed functions, so
    remat replays nothing there: K4 launches 3 forward and 1 backward
    (dpos alone) each way, and the grid is remat off's, bit for bit where
    the remat-off runs agree."""
    from cropnerf_tpu_torch.uncertainty import bayesrays as br
    rb = next(br.bank_ray_batches(bank, cfg.model, 1, RAYS,
                                  torch.Generator(device=dev).manual_seed(9)))
    grids, launched = [], []
    for on in (True, False, False):
        comp = br.ComputeUncertainty(params, with_remat(cfg, on).model,
                                     lod=UNC_LOD)
        launched.append(counted(kernels, lambda: grids.append(
            comp.batch(rb))))
    floor = (grids[1] - grids[2]).abs().max().item()
    dev_on = min((grids[0] - g).abs().max().item() for g in grids[1:])
    want = {k.__name__: 0 for k in kernels}
    want.update(hash_encode=3, hash_encode_bwd=1)
    check(all(n == want for n in launched),
          f"[remat] BayesRays launches {[nonzero(n) for n in launched]} "
          f"(remat on, off, off), expected {nonzero(want)} each")
    check(torch.equal(grids[0], grids[1]) if floor == 0
          else dev_on <= REMAT_NOISE * floor,
          f"[remat] BayesRays grid: remat on deviates {dev_on:.3e} from "
          f"off, whose runs deviate {floor:.3e}")
    log(f"[remat] BayesRays batch of {RAYS} rays at lod {UNC_LOD}, remat on "
        f"and off: launches {nonzero(launched[0])} each way (no replay); "
        f"grid |on - off| {dev_on:.3e} (off runs {floor:.3e}); {card}")
    return {"launches": launched[0], "deviation": dev_on, "floor": floor}


def k4_path_rows(cfg, dev) -> dict:
    """K4 at each hash encode of one ``cfg`` training step (rays x that
    net's samples, uniform positions, a random table of the grid's
    layout): the forward bit for bit and the backward's table and
    position gradients against the plain version with a float64 table,
    and at the field's encode the device ms and ns per position and
    level.  Returns {label: entry} for the encodes that hash."""
    from cropnerf_tpu_torch.ops import hashgrid as hg
    from cropnerf_tpu_torch.ops.cuda import hash_encode as kh
    g = torch.Generator(device=dev).manual_seed(19)
    rows = {}
    for label, n, gc in hash_path_shapes(cfg):
        if label == "field" and cfg.model.field.field_type != "hash":
            continue
        res = hg.level_resolutions(gc.num_levels, gc.min_res, gc.max_res)
        t = 2 ** gc.log2_hashmap_size
        table = torch.rand((sum(hg.level_row_counts(res, t)), 2),
                           generator=g, device=dev) * 2 - 1
        pos = torch.rand((n, 3), generator=g, device=dev)
        table2d, offsets, dense, _ = hg._table_layout(table, res, "auto", t)
        layout = (tuple(res), tuple(offsets), tuple(dense), t)
        cot = torch.randn((n, 2 * len(res)), generator=g, device=dev)
        with torch.no_grad():
            bitwise = torch.equal(kh.hash_encode_fwd(table2d, pos, *layout),
                                  hg.hashgrid_encode_plain(table, pos, res,
                                                           table_size=t))
        dt, dp = kh.hash_encode_bwd(table2d, pos, cot, *layout)
        tt = table.double().requires_grad_(True)
        tp = pos.clone().requires_grad_(True)
        with torch.enable_grad():
            hg.hashgrid_encode_plain(tt, tp, res, table_size=t).backward(
                cot.double())
        k = {"n": n, "levels": len(res), "rows": table2d.shape[0],
             "dense_levels": sum(dense), "group": kh.level_group(len(res)),
             "fwd_bitwise": bitwise,
             "dtable_err": rel_err(dt, tt.grad.reshape(-1, 2)),
             "dpos_err": rel_err(dp, tp.grad)}
        del tt, tp, dt, dp
        check(bitwise and k["dtable_err"] <= HASH_TOL
              and k["dpos_err"] <= DPOS_TOL,
              f"hash_encode at {label} of {gc} disagrees with its plain "
              f"version: {k}")
        if label == "field":
            fwd = pass_ms(lambda: kh.hash_encode_fwd(table2d, pos, *layout),
                          10, HASH_FWD_PASSES)["total"]["median"]
            bwd = pass_ms(lambda: kh.hash_encode_bwd(table2d, pos, cot,
                                                     *layout), 5,
                          HASH_BWD_PASSES)["total"]["median"]
            lookups = n * len(res)
            k.update(fwd_ms=fwd, bwd_ms=bwd,
                     fwd_ns_per_lookup=fwd * 1e6 / lookups,
                     bwd_ns_per_lookup=bwd * 1e6 / lookups)
        rows[label] = k
        del table, pos, cot, table2d
    return rows


def remat_phase(dev, card, bank, kernels, work: Path) -> dict:
    """The presets that keep ``remat`` on (cropnerf-big at 8192 rays,
    cropnerf-huge at 16384, semantic-nerf at 4096) at full widths on the
    [train] bank: the gradient of one batch with remat on against
    REMAT_OFF_RUNS with it off (the loss equal; each leaf within the
    remat-off runs' own deviation, bit for bit where that is 0), exact K4
    launches, step ms and peak memory each way, model TFLOP/s and mfu;
    cropnerf at 32,768 rays with --remat's effect on and off; K4 per
    lookup at each field table; then ``train --method cropnerf-huge``
    through the CLI on the [cli] scene at 600x400, with the preset's remat,
    to a checkpoint that loads, and the watchdog on the card (cropnerf-big,
    remat off, an unreachable floor: 2 rebuilds and one "giving up")."""
    import contextlib
    from cropnerf_tpu_torch import cli
    from cropnerf_tpu_torch.data.dataparser import DataparserConfig
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import make_train_step
    from cropnerf_tpu_torch.train.trainer import (Trainer,
                                                  load_trainer_from_run)
    from cropnerf_tpu_torch.utils.flops import mfu, train_step_flops
    info = {"card": card, "presets": {}, "launches": {}}
    cases = [(name, PRESETS[name]) for name in REMAT_PRESETS] + [
        ("cropnerf", dataclasses.replace(
            PRESETS["cropnerf"],
            train_num_rays_per_batch=REMAT_CROPNERF_RAYS))]
    peak_tflops = PEAK_BF16_FLOPS / 1e12

    def want(k4, n=1):
        w = {k.__name__: 0 for k in kernels}
        w.update(hash_encode=k4[0] * n, hash_encode_bwd=k4[1] * n)
        return w

    for name, cfg in cases:
        check(cfg.model.remat == (name != "cropnerf"),
              f"{name}: remat {cfg.model.remat} in the preset")
        R = cfg.train_num_rays_per_batch
        state = create_train_state(cfg, bank.num_images,
                                   torch.Generator().manual_seed(0), dev)
        entry = {"rays": R}
        if name != "cropnerf":
            launched, losses, grads, same_inputs = {}, [], [], []
            for label, on in [("on", True)] + [(f"off {i}", False)
                                               for i in range(REMAT_OFF_RUNS)]:
                res = {}
                launched[label] = counted(kernels, lambda on=on: res.update(
                    run=remat_gradient(state, with_remat(cfg, on), bank,
                                       dev)))
                loss, g, inputs = res.pop("run")
                losses.append(loss)
                grads.append(g)
                if on:
                    ref_inputs = inputs
                else:       # K4 backward's inputs, bit for bit
                    same_inputs.append(
                        len(inputs) == len(ref_inputs)
                        == REMAT_K4[name][False][1]
                        and all(a[0] == b[0] and torch.equal(a[1], b[1])
                                and torch.equal(a[2], b[2])
                                for a, b in zip(inputs, ref_inputs)))
                del inputs
            del ref_inputs
            g_on, offs = grads[0], grads[1:]
            leaves = {}
            for k in offs[0]:
                floor = max((a[k] - b[k]).abs().max().item()
                            for i, a in enumerate(offs) for b in offs[i + 1:])
                dev_on = min((g_on[k] - o[k]).abs().max().item()
                             for o in offs)
                exact = all(torch.equal(g_on[k], o[k]) for o in offs)
                leaves[k] = (dev_on, floor, exact)
            groups = {}
            for k, (dev_on, floor, _) in leaves.items():
                grp = groups.setdefault(leaf_group(k), [0.0, 0.0])
                grp[0], grp[1] = max(grp[0], dev_on), max(grp[1], floor)
            log(f"[remat] {name} one batch of {R} rays, remat on against "
                f"{REMAT_OFF_RUNS} runs off: loss {losses[0].item():.6f} on, "
                f"{[l.item() for l in losses[1:]]} off; K4 backward's "
                f"inputs bit for bit {same_inputs}; largest |on - off| per "
                f"leaf group (the off runs' own): "
                + ", ".join(f"{k} {v[0]:.3e} ({v[1]:.3e})"
                            for k, v in groups.items())
                + f"; K4 launches on {nonzero(launched['on'])}, off "
                f"{nonzero(launched['off 0'])}; {card}")
            for label, n in launched.items():
                k4 = REMAT_K4[name][label == "on"]
                check(n == want(k4), f"[remat] {name} {label}: launches "
                      f"{nonzero(n)}, expected {nonzero(want(k4))}")
            check(all(torch.equal(losses[0], l) for l in losses[1:]),
                  f"[remat] {name}: the loss differs with remat on and off")
            check(all(same_inputs), f"[remat] {name}: K4 backward's inputs "
                  f"differ with remat on and off: {same_inputs}")
            check(set(g_on) == set(offs[0]), f"[remat] {name}: leaves "
                  f"{sorted(g_on)} on, {sorted(offs[0])} off")
            for k, (dev_on, floor, exact) in leaves.items():
                check(exact if floor == 0 else dev_on <= REMAT_NOISE * floor,
                      f"[remat] {name} {k}: remat on deviates {dev_on:.3e} "
                      f"from remat off, whose runs deviate {floor:.3e}")
            del grads, offs, g_on
            entry.update(loss=losses[0].item(), deviation=groups,
                         k4_bwd_inputs_equal=same_inputs)
            if name == "cropnerf-big":
                entry["bayesrays"] = remat_bayesrays(state.params, cfg, bank,
                                                     kernels, dev, card)
        flops = train_step_flops(cfg)["model_flops_per_step"]
        for on in (True, False):
            step_fn = make_train_step(with_remat(cfg, on))
            gen = torch.Generator(device=dev).manual_seed(8)
            times, mem = [], {}

            def run():
                step_fn(state, bank, gen)

            def steps():
                times.extend(wall_ms(run) for _ in range(1 + REMAT_TIMED))
                torch.cuda.synchronize()
                mem["base"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                mem["peak"] = torch.cuda.max_memory_allocated()

            n = 2 + REMAT_TIMED
            launches = counted(kernels, steps)
            path = f"{name} remat {'on' if on else 'off'}, {n} steps"
            info["launches"][path] = launches
            check(launches == want(REMAT_K4[name][on], n),
                  f"[remat] {path}: launches {nonzero(launches)}, expected "
                  f"{nonzero(want(REMAT_K4[name][on], n))}")
            med = statistics.median(times[1:])
            rate = mfu(flops, med / 1e3, peak_tflops)
            entry["on" if on else "off"] = {
                "median_ms": med, "runs_ms": times[1:], "first_ms": times[0],
                "peak_gib": mem["peak"] / 2**30,
                "step_gib": (mem["peak"] - mem["base"]) / 2**30,
                "rays_per_s": R / med * 1e3, **rate}
        check(state.step == 2 * n and all(
            torch.isfinite(p).all() for p in state.params.parameters()),
              f"[remat] {name}: step {state.step}, parameters not finite")
        on, off = entry["on"], entry["off"]
        entry.update(peak_ratio=off["peak_gib"] / on["peak_gib"],
                     step_ratio=off["step_gib"] / on["step_gib"],
                     time_cost=on["median_ms"] / off["median_ms"] - 1,
                     model_flops_per_step=flops)
        for label, e in (("on", on), ("off", off)):
            log(f"[remat] {name} {R} rays, remat {label}: step median "
                f"{e['median_ms']:.2f} ms of {REMAT_TIMED} (runs "
                + ", ".join(f"{v:.2f}" for v in e["runs_ms"])
                + f"; first {e['first_ms']:.2f}), {e['rays_per_s']:.0f} "
                f"rays/s; peak {e['peak_gib']:.3f} GiB, of it the step's "
                f"own {e['step_gib']:.3f} GiB; {card}")
        log(f"[remat] {name}: remat off / on peak {entry['peak_ratio']:.3f}x "
            f"(the step's own {entry['step_ratio']:.3f}x), remat's step "
            f"time {entry['time_cost']:+.1%}; model FLOPs per step "
            f"{flops:.4e} (utils/flops.py train_step_flops): "
            f"{on['tflops_per_s']:.3f} TFLOP/s, mfu {on['mfu']:.5f} with "
            f"remat on, {off['tflops_per_s']:.3f} / {off['mfu']:.5f} off, "
            f"against {peak_tflops:.0f} TFLOP/s bf16; {card}")
        entry["k4"] = rows = k4_path_rows(cfg, dev)
        log(f"[remat] {name} K4 at each encode of the step against its "
            f"plain version (float64 table; limits {HASH_TOL}, {DPOS_TOL}): "
            + "; ".join(f"{label} [{k['n']},3] x {k['levels']} levels on "
                        f"{k['rows']} rows ({k['dense_levels']} dense): "
                        f"forward bit-identical {k['fwd_bitwise']}, dtable "
                        f"{k['dtable_err']:.2e}, dpos {k['dpos_err']:.2e}"
                        for label, k in rows.items()) + f"; {card}")
        k = rows.get("field")
        if k is not None:
            log(f"[remat] {name} K4 at the field's encode: forward "
                f"{k['fwd_ms']:.4f} ms ({k['fwd_ns_per_lookup']:.4f} ns a "
                f"position-level), backward {k['bwd_ms']:.4f} ms "
                f"({k['bwd_ns_per_lookup']:.4f} ns); {card}")
        info["presets"][name] = entry
        del state
        torch.cuda.empty_cache()

    # the CLI: train cropnerf-huge with the preset's remat to a checkpoint
    data = cli_data(work, "cropnerf")
    run = work / "remat_huge"
    res = {}
    t0 = time.perf_counter()
    launches = counted(kernels, lambda: res.update(tr=cli.main([
        "train", "--method", "cropnerf-huge", "--data", str(data),
        "--output", str(run), "--max-steps", str(REMAT_CLI_STEPS)])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = res.pop("tr")
    h, w = int(tr.eval_outputs.height[0]), int(tr.eval_outputs.width[0])
    chunks = -(-h * w // tr.cfg.eval_num_rays_per_chunk)
    expect = want((6 * REMAT_CLI_STEPS + 3 * chunks * len(tr.eval_images),
                   3 * REMAT_CLI_STEPS))
    info["launches"][f"cli train cropnerf-huge {REMAT_CLI_STEPS} steps"] = \
        launches
    ckpt = run / "checkpoints" / f"step-{REMAT_CLI_STEPS:09d}.pt"
    check(tr.cfg.model.remat and tr.state.step == REMAT_CLI_STEPS
          and ckpt.is_file(), f"[remat] train cropnerf-huge: remat "
          f"{tr.cfg.model.remat}, step {tr.state.step}, {ckpt.name}")
    check(launches == expect, f"[remat] train cropnerf-huge: launches "
          f"{nonzero(launches)}, expected {nonzero(expect)} (the end's "
          f"eval render {chunks} chunks of {h}x{w})")
    last = metrics_log(run)[-1]
    loaded = load_trainer_from_run(run, device=dev)
    same = all(torch.equal(v, loaded.state.params.state_dict()[k])
               for k, v in tr.state.params.state_dict().items())
    check(same and loaded.state.step == REMAT_CLI_STEPS
          and loaded.cfg.model.remat,
          f"[remat] the cropnerf-huge checkpoint does not load back")
    final = {k: v for k, v in last.items() if k.startswith("eval_all")}
    check(all(math.isfinite(v) for v in final.values()) and final,
          f"[remat] cropnerf-huge final eval {final}")
    log(f"[remat] train --method cropnerf-huge --max-steps "
        f"{REMAT_CLI_STEPS} (remat on, {tr.cfg.train_num_rays_per_batch} "
        f"rays, {w}x{h} views): {wall:.2f} s, launches {nonzero(launches)}; "
        f"{ckpt.name} ({ckpt.stat().st_size / 2**20:.1f} MiB) loads bit for "
        f"bit; final eval {final}; {card}")
    info["cli"] = {"wall_s": wall, "launches": launches, "final": final,
                   "checkpoint_mib": ckpt.stat().st_size / 2**20}
    del tr, loaded
    torch.cuda.empty_cache()

    # the watchdog on the card: an unreachable floor on cropnerf-big
    cfg = with_remat(PRESETS["cropnerf-big"], False)
    trainer = Trainer(cfg, DataparserConfig(data_dir=data),
                      work / "watchdog", device=dev, min_rays_per_s=1e15)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        m = trainer.train(num_steps=WATCHDOG_STEPS, log_every=WATCHDOG_LOG)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    said = {key: [ln.split("]")[0] + "]" for ln in lines if key in ln]
            for key in ("rebuilding the train step", "giving up")}
    for ln in lines:
        if "WATCHDOG" in ln:
            log(f"[remat] watchdog: {ln}")
    check(trainer._slow_retries == 2
          and said["rebuilding the train step"] == ["[step 10]", "[step 20]"]
          and said["giving up"] == ["[step 30]"]
          and trainer.state.step == WATCHDOG_STEPS
          and math.isfinite(m["loss"]),
          f"[remat] watchdog: {said}, {trainer._slow_retries} rebuilds, "
          f"step {trainer.state.step}, loss {m['loss']}")
    log(f"[remat] watchdog, cropnerf-big remat off, floor 1e15 rays/s, "
        f"{WATCHDOG_STEPS} steps logged every {WATCHDOG_LOG}: {said}; loss "
        f"{m['loss']:.5f}; {wall:.2f} s; {card}")
    info["watchdog"] = {"said": said, "wall_s": wall, "loss": m["loss"]}
    del trainer
    torch.cuda.empty_cache()
    return info


# ---- slice 15: K3's wide heads on their paths, the [wide] phase ------------

WIDE_PRESETS = ("cropnerf-mxu-big", "cropnerf-mxu-huge")
WIDE_REPEATS = 2                # timed exports after the counted one
WIDE_FLIP = 1e-2                # a semantic flag may flip only this close to
                                # its threshold, in sigmoid units
WIDE_CLI_STEPS = 50             # train --method cropnerf-mxu-huge (600x400)
WIDE_TRAIN_STEPS = 3            # cropnerf-mxu-big's timed steps after a first
WIDE_CLI_EXPORT_SIDE = 64
WIDE_CLI_UNC_ITERS = 2


def wide_heads(dev) -> tuple:
    """The heads of cropnerf-mxu-big and -huge at their published widths,
    random weights from a seeded generator: ({label: wbs}, {label: the
    BayesRays batch of the preset, 4096 rays x its samples a ray}).  The
    semantic head, [30, 128, 128, 1] in both, is taken once, at -big's
    larger batch."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.vanilla import vanilla_field_init
    heads, batch = {}, {}
    for preset in WIDE_PRESETS:
        m = PRESETS[preset].model
        f = vanilla_field_init(m.field, 8, torch.Generator().manual_seed(17),
                               dev)
        tag = preset.split("-")[-1]
        pairs = [(f"-{tag} colour head", f.mlp_color)]
        if tag == "big":
            pairs.insert(0, ("semantic head", f.mlp_semantic))
        for label, mlp in pairs:
            heads[label] = [t.detach() for w, b in zip(mlp.w, mlp.b)
                            for t in (w, b.reshape(1, -1))]
            batch[label] = RAYS * m.num_nerf_samples_per_ray
    return heads, batch


class k3_plain:
    """K3's plain version in place of its kernels (``fused_mlp``, which
    ops/mlp.py looks up at each call), the same bf16 arithmetic on the
    card: everything else of the path runs as it does."""

    def __enter__(self):
        from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
        self.km, self.kernel = km, km.fused_mlp
        km.fused_mlp = lambda x, wbs, dtype=torch.bfloat16: \
            km.fused_mlp_plain(x, wbs, dtype)

    def __exit__(self, *exc):
        self.km.fused_mlp = self.kernel


def traced(fn) -> dict:
    """One call under torch.profiler: its wall ms, the device's busy ms and
    K3's share (the wgmma kernels mlp_fwd_kernel, mlp_bwd_kernel and the
    weight-gradient column sums), profiled again if a window records no
    device time, up to PROFILE_TRIES windows."""
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms = wall_ms(fn)
        rows = [(e.key, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(v for _, v in rows)
        if busy > 0:
            return dict(wall_ms=ms, device_ms=busy, k3_ms=sum(
                v for k, v in rows if "mlp_fwd_kernel" in k
                or "mlp_bwd_kernel" in k))
    return dict(wall_ms=ms, device_ms=math.nan, k3_ms=math.nan)


def export_vs_k3_plain(clouds, ref, thr) -> dict:
    """A volume export against the same export with K3's plain version:
    the density cloud (rows set by K2's density) the same rows in the same
    order; its colours (the colour head) and alphas (the semantic head's
    sigmoid) within TOL; each density row's semantic and colormap flags
    the same, but where the plain path's alpha lies within WIDE_FLIP of the
    flag's threshold (the last bit of a logit there decides)."""
    d, dp = clouds["density"], ref["density"]
    check(d.points.shape == dp.points.shape
          and np.array_equal(d.points, dp.points),
          f"export: {len(d.points)} density rows vs {len(dp.points)} with "
          "K3's plain version, or not in the same order")

    def keys(pts):
        return np.ascontiguousarray(pts).view(np.dtype((np.void, 12))).ravel()

    rows = keys(d.points)
    out = dict(rows=len(rows),
               colour_err=float(np.abs(d.colors - dp.colors).max()
                                / max(np.abs(dp.colors).max(), 1e-6)),
               alpha_err=float(np.abs(d.alpha - dp.alpha).max()))
    sem_at = 1 / (1 + math.exp(-thr["semantic_threshold"]))
    for name, at in (("semantic", sem_at),
                     ("semantic_colormap", thr["colormap_threshold"])):
        a = np.isin(rows, keys(clouds[name].points))
        b = np.isin(rows, keys(ref[name].points))
        flips = np.nonzero(a != b)[0]
        out[f"{name}_rows"] = int(a.sum())
        out[f"{name}_flips"] = len(flips)
        check(np.all(np.abs(dp.alpha[flips] - at) <= WIDE_FLIP),
              f"export {name}: {len(flips)} rows flip, some away from the "
              f"threshold {at:.4f}")
    check(out["colour_err"] <= TOL and out["alpha_err"] <= TOL,
          f"export colours / alphas against K3's plain version: {out}")
    return out


def wide_phase(dev, card, bank, kernels, work: Path) -> dict:
    """cropnerf-mxu-big and -huge at their published widths, random weights
    from a seeded generator ([wide] lines): the EXPORT_SIDE^3 volume export
    with colours and UNC_BATCHES BayesRays batches of RAYS rays on the
    semantics and on the rgb channel, each with exact launch counts (K3 on
    its wgmma kernels, none on the stream route's counters; counts zeroed
    just before each call and read just after), wall ms and, from one
    traced call, device ms with K3's share.  The export is held against
    the same export with K3's plain version (export_vs_k3_plain) and
    against the plain path's point counts, the Hessians against the plain
    path's.  Then through the CLI on the [cli] scene at 600x400: train
    --method cropnerf-mxu-huge --max-steps WIDE_CLI_STEPS, export
    --render-rgb at WIDE_CLI_EXPORT_SIDE a side and uncertainty --iters
    WIDE_CLI_UNC_ITERS, with K3's launches exact.  Returns (numbers for
    the JSON line, the -huge export and BayesRays batch for the trace).
    First, cropnerf-mxu-big's training step at its published batch (8192
    rays, 512/256/128 samples): 1 + WIDE_TRAIN_STEPS steps with exact K1
    launches, the first step's losses against the all-plain path's, step
    ms and peak GiB."""
    from cropnerf_tpu_torch import cli
    from cropnerf_tpu_torch.export.ply import ply_vertex_count
    from cropnerf_tpu_torch.export.volume import (export_and_write,
                                                  orthographic_ray_grid,
                                                  sample_volume)
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import model_init
    from cropnerf_tpu_torch.train.trainer import load_trainer_from_run
    from cropnerf_tpu_torch.uncertainty import bayesrays as br
    names = [k.__name__ for k in kernels]

    def want(**n):
        return {k: n.get(k, 0) for k in names}

    aabb = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    n_chunks = -(-EXPORT_SIDE ** 2 // EXPORT_RAYS)
    info, trace_steps = {"card": card, "launches": {}}, {}
    g = torch.Generator(device=dev).manual_seed(19)

    # ---- cropnerf-mxu-big's training step
    cfg = PRESETS["cropnerf-mxu-big"]
    n_steps = 1 + WIDE_TRAIN_STEPS
    t, _ = train_vs_plain(cfg, all_plain_cfg(cfg), bank, kernels, n_steps,
                          "[wide] cropnerf-mxu-big train", dev, plain_steps=1)
    expect = want(fused_pe_nerf=n_steps, fused_pe_nerf_bwd=n_steps)
    check(t["launches"] == expect, f"[wide] cropnerf-mxu-big training "
          f"launches {nonzero(t['launches'])}, expected {nonzero(expect)}")
    info["launches"]["cropnerf-mxu-big train"] = t["launches"]
    info["cropnerf-mxu-big train"] = t
    log(f"[wide] cropnerf-mxu-big train step at "
        f"{cfg.train_num_rays_per_batch} rays, samples "
        f"{cfg.model.num_proposal_samples_per_ray}/"
        f"{cfg.model.num_nerf_samples_per_ray}: median {t['median_ms']:.2f} "
        f"ms of {WIDE_TRAIN_STEPS} ({t['rays_per_s']:.0f} rays/s), runs "
        + ", ".join(f"{v:.2f}" for v in t["runs_ms"])
        + f" ms; plain path's first step {t['plain_runs_ms'][0]:.2f} ms; "
        f"first step's loss terms {t['first_terms']} vs plain "
        f"{t['plain_first_terms']}; launches {nonzero(t['launches'])}; peak "
        f"{t['peak_gib']:.2f} GiB; {card}")
    torch.cuda.empty_cache()

    for preset in WIDE_PRESETS:
        cfg = PRESETS[preset]
        m = cfg.model
        plain_m = dataclasses.replace(m, field=dataclasses.replace(
            m.field, mlp_impl="xla"))
        params = model_init(m, bank.num_images,
                            torch.Generator().manual_seed(0), dev)
        entry = {}
        # ---- the volume export
        thr = export_thresholds(params, m.field, g, dev)
        kw = dict(num_points_per_side=EXPORT_SIDE, render_rgb=True, **thr)
        out_dir = work / f"wide_{preset}"
        res = {}
        exp_want = want(fused_pe_density=n_chunks, fused_mlp=2 * n_chunks)
        launches = counted(kernels, lambda: res.update(first=wall_ms(
            lambda: res.update(paths=export_and_write(params, m, aabb,
                                                      out_dir, **kw)))))
        check(launches == exp_want, f"[wide] {preset} export launches "
              f"{nonzero(launches)}, expected {nonzero(exp_want)}")
        info["launches"][f"{preset} export"] = launches
        runs = [wall_ms(lambda: export_and_write(params, m, aabb, out_dir,
                                                 **kw))
                for _ in range(WIDE_REPEATS)]
        tr_exp = traced(lambda: export_and_write(params, m, aabb, out_dir,
                                                 **kw))
        points = {k: ply_vertex_count(v) for k, v in res["paths"].items()}
        clouds = sample_volume(params, m, aabb, **kw)
        with k3_plain():
            vs = export_vs_k3_plain(clouds, sample_volume(params, m, aabb,
                                                          **kw), thr)
        plain_points = {k: len(c.points) for k, c in
                        sample_volume(params, plain_m, aabb, **kw).items()}
        check(points["density"] > points["semantic"] > 0, f"[wide] {preset} "
              f"export points {points}")
        for k in points:
            check(abs(points[k] - plain_points[k]) <= 0.01 * plain_points[k]
                  + 10, f"[wide] {preset} export {k}: {points[k]} points vs "
                  f"plain path {plain_points[k]}")
        entry["export"] = dict(first_ms=res["first"], runs_ms=runs,
                               points=points, plain_points=plain_points,
                               vs_k3_plain=vs, **tr_exp)
        log(f"[wide] {preset} export {EXPORT_SIDE}^3 with colours: first "
            f"{res['first']:.1f} ms, runs "
            + ", ".join(f"{v:.1f}" for v in runs)
            + f" ms; traced {tr_exp['wall_ms']:.1f} ms, device "
            f"{tr_exp['device_ms']:.3f} ms of it K3 {tr_exp['k3_ms']:.3f} "
            f"ms; launches {nonzero(launches)} ({n_chunks} chunks); points "
            f"{points} (plain path {plain_points}); against K3's plain "
            f"version: {vs}; {card}")
        del clouds, res

        # ---- the BayesRays pass, both channels
        batches = list(br.bank_ray_batches(
            bank, m, UNC_BATCHES, RAYS,
            torch.Generator(device=dev).manual_seed(9)))
        for channel, per in (("semantics", 1), ("rgb", 3)):
            comp = br.ComputeUncertainty(params, m, lod=UNC_LOD,
                                         channel=channel)
            grid, runs = [], []

            def run_all():
                acc = None
                for rb in batches:
                    t0 = time.perf_counter()
                    h = comp.batch(rb)
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
                    acc = h if acc is None else acc + h
                grid.append(acc)

            unc_want = want(fused_pe_density=UNC_BATCHES,
                            fused_pe_density_bwd=per * UNC_BATCHES,
                            fused_mlp=UNC_BATCHES,
                            fused_mlp_bwd=per * UNC_BATCHES)
            launches = counted(kernels, run_all)
            check(launches == unc_want, f"[wide] {preset} {channel} "
                  f"launches {nonzero(launches)}, expected "
                  f"{nonzero(unc_want)}")
            info["launches"][f"{preset} uncertainty {channel}"] = launches
            hess = grid[0]
            plain = br.ComputeUncertainty(params, plain_m, lod=UNC_LOD,
                                          channel=channel)
            ref = sum(plain.batch(rb) for rb in batches)
            l2 = ((hess - ref).norm() / ref.norm()).item()
            hot = len(set(hess.topk(1000).indices.tolist())
                      & set(ref.topk(1000).indices.tolist())) / 1000
            check(bool(torch.isfinite(hess).all()) and hess.max() > 0
                  and l2 <= GRAD_TOL and hot >= 0.9,
                  f"[wide] {preset} {channel} Hessian vs plain path: L2 "
                  f"{l2:.3e}, hottest 1000 shared {hot:.3f}")
            check(torch.equal(comp.batch(batches[0]), comp.batch(batches[0])),
                  f"[wide] {preset} {channel} batch differs between two runs")
            tr_unc = traced(lambda: comp.batch(batches[0]))
            med = statistics.median(runs[1:])
            entry[f"uncertainty {channel}"] = dict(
                runs_ms=runs, median_ms=med, vs_plain_l2=l2, hot1000=hot,
                **tr_unc)
            log(f"[wide] {preset} BayesRays {channel}, {UNC_BATCHES} batches "
                f"of {RAYS} rays ({RAYS * m.num_nerf_samples_per_ray} "
                f"samples), lod {UNC_LOD}: median {med:.2f} ms a batch, runs "
                + ", ".join(f"{v:.2f}" for v in runs) + f"; traced "
                f"{tr_unc['wall_ms']:.2f} ms, device {tr_unc['device_ms']:.3f}"
                f" ms of it K3 {tr_unc['k3_ms']:.3f} ms; launches "
                f"{nonzero(launches)}; vs plain path L2 {l2:.3e}, hottest "
                f"1000 shared {hot:.3f}; {card}")
            if preset == "cropnerf-mxu-huge" and channel == "semantics":
                trace_steps[f"{preset} uncertainty batch"] = (
                    lambda comp=comp, rb=batches[0]: comp.batch(rb))
            del comp, plain, grid, hess, ref
        if preset == "cropnerf-mxu-huge":
            trace_steps[f"{preset} export (sample_volume)"] = (
                lambda params=params, m=m, kw=kw:
                sample_volume(params, m, aabb, **kw))
        info[preset] = entry
        del params, batches
        torch.cuda.empty_cache()

    # ---- the CLI: cropnerf-mxu-huge on the [cli] scene at 600x400
    data = cli_data(work, "cropnerf")
    run = work / "wide_huge"
    cmds, res = {}, {}

    def drive(name, argv):
        t0 = time.perf_counter()
        n = counted(kernels, lambda: res.update({name: cli.main(argv)}))
        torch.cuda.synchronize()
        cmds[name] = time.perf_counter() - t0
        info["launches"][f"cli cropnerf-mxu-huge {name}"] = n
        log(f"[wide] cli cropnerf-mxu-huge {name}: {cmds[name]:.2f} s, "
            f"launches {nonzero(n)}")
        return n

    n = drive("train", ["train", "--method", "cropnerf-mxu-huge", "--data",
                        str(data), "--output", str(run), "--max-steps",
                        str(WIDE_CLI_STEPS)])
    check(n["fused_pe_nerf_bwd"] == WIDE_CLI_STEPS
          and n["fused_pe_nerf"] >= WIDE_CLI_STEPS
          and all(n[k] == 0 for k in ("fused_mlp", "fused_mlp_bwd",
                                      "fused_mlp_stream", "fused_mlp_stream_bwd")),
          f"[wide] cli train launches {nonzero(n)}")
    trainer = load_trainer_from_run(run, device=dev)
    check(trainer.state.step == WIDE_CLI_STEPS, "[wide] cli train: step "
          f"{trainer.state.step}")
    box = np.asarray(trainer.train_outputs.scene_box, np.float32)
    thr = export_thresholds(trainer.state.params, trainer.cfg.model.field,
                            g, dev)
    chunks = -(-orthographic_ray_grid(box, WIDE_CLI_EXPORT_SIDE)[0].shape[0]
               // EXPORT_RAYS)
    del trainer
    n = drive("export", ["export", "--run-dir", str(run), "--render-rgb",
                         "--num-points-per-side", str(WIDE_CLI_EXPORT_SIDE)]
              + [a for k, v in thr.items()
                 for a in (f"--{k.replace('_', '-')}", repr(v))])
    check(n == want(fused_pe_density=chunks, fused_mlp=2 * chunks),
          f"[wide] cli export launches {nonzero(n)} ({chunks} chunks)")
    points = {k: ply_vertex_count(v) for k, v in res["export"].items()}
    check(points["density"] > 0, f"[wide] cli export points {points}")
    n = drive("uncertainty", ["uncertainty", "--run-dir", str(run), "--iters",
                              str(WIDE_CLI_UNC_ITERS)])
    u = WIDE_CLI_UNC_ITERS
    check(n == want(fused_pe_density=u, fused_pe_density_bwd=u, fused_mlp=u,
                    fused_mlp_bwd=u), f"[wide] cli uncertainty launches "
          f"{nonzero(n)}")
    grid = np.load(res["uncertainty"])
    check(bool(np.isfinite(grid).all()) and grid.max() > 0,
          "[wide] cli uncertainty grid")
    info["cli"] = dict(command_s=cmds, export_points=points,
                       export_chunks=chunks)
    log(f"[wide] cli cropnerf-mxu-huge wall s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in cmds.items())
        + f"; export {WIDE_CLI_EXPORT_SIDE} a side, points {points}; {card}")
    return info, trace_steps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: no CUDA device is visible")
    repo = Path(__file__).resolve().parent
    check((repo / "cropnerf_tpu_torch" / "csrc").is_dir(),
          f"the repository is not beside {Path(__file__).name}")
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cropnerf_tpu_torch.core.cameras import Cameras, near_far_collider
    from cropnerf_tpu_torch.core.rays import RayBundle
    from cropnerf_tpu_torch.export.volume import export_and_write
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.model import forward, model_init
    from cropnerf_tpu_torch.models.vanilla import (DIR_FREQS, POS_FREQS,
                                                   fused_field_weights)
    from cropnerf_tpu_torch.ops.cuda import build
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield
    from cropnerf_tpu_torch.ops.cuda.hash_encode import (hash_encode,
                                                         hash_encode_bwd)
    from cropnerf_tpu_torch.ops.cuda.mlp_plan import program_key
    from cropnerf_tpu_torch.ops.cuda.fused_mlp import (fused_mlp,
                                                       fused_mlp_bwd,
                                                       fused_mlp_plain)
    from cropnerf_tpu_torch.ops.cuda.fused_pe_field import (
        fused_pe_density, fused_pe_density_bwd, fused_pe_density_plain,
        fused_pe_mlp, fused_pe_mlp_bwd, fused_pe_mlp_stream,
        fused_pe_mlp_stream_bwd, fused_pe_nerf, fused_pe_nerf_bwd,
        fused_pe_nerf_plain)
    from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
    from cropnerf_tpu_torch.ops.posenc import nerf_encoding
    from cropnerf_tpu_torch.train.step import make_render_fn

    lap = phase_clock()
    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s for {', '.join(reports)} "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    from cropnerf_tpu_torch.native import pointcloud_ops as native
    t0 = time.perf_counter()
    native_lib = native.build()
    native_flags = subprocess.run(
        ["make", "-s", "-C", str(native_lib.parents[1] / "native"), "flags"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"[build] {time.perf_counter() - t0:.1f} s for the native "
        f"point-cloud ops ({native_lib.relative_to(repo)}: {native_flags})")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "spill", "error", "warning")):
                log(f"[build] {name}: {line.strip()}")

    # ---- 2. the card -----------------------------------------------------
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi.split(',')[0].strip()}, {smi.split(',')[1].strip()}"
    log(f"[card] torch: {kind}; count {torch.cuda.device_count()}")
    log(f"[card] nvidia-smi: {smi}")

    cfg = PRESETS["cropnerf-mxu"]
    m = cfg.model
    params = model_init(m, num_images=8,
                        generator=torch.Generator().manual_seed(0),
                        device=dev)
    fcfg = m.field
    base, top, color, sem = fused_field_weights(params.field, fcfg)
    g = torch.Generator(device=dev).manual_seed(1)

    lap("build and card")
    # ---- 3. kernels against their plain versions --------------------------
    kernels = {}
    enc_w = 3 * (1 + 2 * POS_FREQS)
    H = fcfg.hidden_dim
    trunk_dims = ([enc_w, H, H, H, H], [H + enc_w, H, H, H, 1 + fcfg.geo_feat_dim])
    trunk_macs = mlp_macs(trunk_dims[0]) + mlp_macs(trunk_dims[1])
    de = color[1].shape[0]
    head_macs = ((fcfg.geo_feat_dim + de) * fcfg.hidden_dim_color
                 + fcfg.hidden_dim_color * 3
                 + mlp_macs([fcfg.geo_feat_dim, fcfg.hidden_dim_semantics,
                             fcfg.num_semantic_classes]))
    weights_k1 = [*base, *top, *color, *sem]
    sem_wbs = [w for pair in zip(params.field.mlp_semantic.w,
                                 params.field.mlp_semantic.b)
               for w in (pair[0], pair[1].reshape(1, -1))]
    col_wbs = [w for pair in zip(params.field.mlp_color.w,
                                 params.field.mlp_color.b)
               for w in (pair[0], pair[1].reshape(1, -1))]
    smem = {
        "fused_pe_nerf": kfield.smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, color, sem, de=de, device=dev)[2], True),
        "fused_pe_density": kfield.smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, device=dev)[2], False),
        "fused_mlp semantic head": kmlp.net_layout(sem_wbs)[2],
        "fused_mlp colour head": kmlp.net_layout(col_wbs)[2]}
    wide, wide_batch = wide_heads(dev)
    smem.update({f"fused_mlp {label} (x stages a warpgroup)": (
        kmlp.net_layout(w)[2], kmlp.net_layout(w)[4])
        for label, w in wide.items()})
    for label, (F, hw, layers, _) in STREAM_K5.items():
        din = 3 * (1 + 2 * F)
        widths = [hw] * (layers - 1) + [1]
        smem[f"fused_mlp_stream {label} (forward, backward)"] = tuple(
            kmlp.stream_smem_bytes(program_key(din, widths, 3, F, bw), bw)
            for bw in (False, True))
    log("[build] dynamic shared memory per block at the path's widths: "
        + ", ".join(f"{k} {v} B" for k, v in smem.items()))
    check(all(min(v) > 0 if isinstance(v, tuple) else v > 0
              for v in smem.values()), f"kernel layouts {smem}")

    def field_inputs(n):
        x = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        d = torch.randn((n, 3), generator=g, device=dev)
        app = params.field.appearance.mean(0).expand(n, -1)
        extras = torch.cat([nerf_encoding(d / d.norm(dim=-1, keepdim=True),
                                          DIR_FREQS), app], -1).contiguous()
        return x, extras

    with torch.no_grad():
        # K1 fused_pe_nerf: forward/render field, rays x 48 samples
        n1 = RAYS * m.num_nerf_samples_per_ray
        x, ex = field_inputs(n1)
        k1 = lambda: fused_pe_nerf(x, ex, base, top, color, sem, POS_FREQS)  # noqa: E731
        p1 = lambda: fused_pe_nerf_plain(x, ex, base, top, color, sem, POS_FREQS)  # noqa: E731
        got, ref = k1(), p1()
        fwd_same = all(torch.equal(a, b) for a, b in zip(got, k1()))
        err_rel = max(rel_err(a, b) for a, b in zip(got, ref))
        err_abs = max(abs_err(a, b) for a, b in zip(got, ref))
        xr, exr = x[:n1 - 77].contiguous(), ex[:n1 - 77].contiguous()
        ragged = max(rel_err(a, b) for a, b in zip(
            fused_pe_nerf(xr, exr, base, top, color, sem, POS_FREQS),
            fused_pe_nerf_plain(xr, exr, base, top, color, sem, POS_FREQS)))
        out_bytes = nbytes(*got)
        kernels["fused_pe_nerf"] = dict(
            shape=f"x [{n1},3], extras [{n1},{de}] -> t [{n1},16], rgb [{n1},3], sem [{n1},1]",
            source="cropnerf_tpu_torch/csrc/fused_pe_field.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:423",
            rel_err=err_rel, max_abs_err=err_abs, ragged_n=n1 - 77,
            ragged_rel_err=ragged, deterministic=fwd_same,
            passes=pass_ms(k1, 10, FWD_PASSES), call_ms=cuda_ms(k1, 10),
            plain_ms=device_ms(p1, 5),
            flops=2.0 * n1 * (trunk_macs + head_macs),
            bytes=nbytes(x, ex, *weights_k1) + out_bytes)

        # K1 backward: the train step's field, 4096 rays x 48 samples, and a
        # ragged N; cotangents from a seeded generator
        wd = [w.detach() for w in weights_k1]
        nb_, nt_, nc_ = len(base), len(top), len(color)

        def groups(ws):
            return (ws[:nb_], ws[nb_:nb_ + nt_], ws[nb_ + nt_:nb_ + nt_ + nc_],
                    ws[nb_ + nt_ + nc_:])

        cot_g = torch.Generator(device=dev).manual_seed(2)

        def bwd_case(n):
            return (x[:n].contiguous(), ex[:n].contiguous(),
                    [torch.randn((n, c), generator=cot_g, device=dev)
                     for c in (got[0].shape[1], got[1].shape[1],
                               got[2].shape[1])])

        def kernel_bwd(xb, exb, cots):
            dx, dex, *gs = fused_pe_nerf_bwd(xb, exb, *groups(wd), POS_FREQS,
                                             *cots, False)
            return [dx, dex] + [t for grp in gs for t in grp]

        def plain_bwd(xb, exb, cots, dtype=torch.bfloat16):
            leaves = [t.clone().requires_grad_(True) for t in (xb, exb, *wd)]
            with torch.enable_grad():
                outs = fused_pe_nerf_plain(leaves[0], leaves[1],
                                           *groups(leaves[2:]), POS_FREQS,
                                           dtype)
                return list(torch.autograd.grad(outs, leaves, cots))

        def bwd_errors(got_g, ref_g):
            w_err = max(rel_err(a, b) for a, b in zip(got_g[2:], ref_g[2:]))
            rows = [row_agreement(a, b) for a, b in zip(got_g[:2], ref_g[:2])]
            return w_err, rows

        bwd = {}
        for n in (n1, n1 - 77):
            xb, exb, cots = bwd_case(n)
            got_g, ref_g = kernel_bwd(xb, exb, cots), plain_bwd(xb, exb, cots)
            bwd[n] = bwd_errors(got_g, ref_g) + (
                max(abs_err(a, b) for a, b in zip(got_g, ref_g)),)
            if n == n1:
                again = kernel_bwd(xb, exb, cots)
                deterministic = all(torch.equal(a, b)
                                    for a, b in zip(got_g, again))
                ref32 = plain_bwd(xb, exb, cots, torch.float32)
                vs_f32 = ([rel_err(a, b) for a, b in zip(got_g, ref32)],
                          [rel_err(a, b) for a, b in zip(ref_g, ref32)])
                xk, exk, cotk = xb, exb, cots
                del again, ref32
            del got_g, ref_g
        kb = lambda: kernel_bwd(xk, exk, cotk)  # noqa: E731
        pb = lambda: plain_bwd(xk, exk, cotk)  # noqa: E731
        head_last = fcfg.hidden_dim_color * 3 + (
            fcfg.hidden_dim_semantics * fcfg.num_semantic_classes)
        sem0 = fcfg.geo_feat_dim * fcfg.hidden_dim_semantics
        fwd_macs = trunk_macs + head_macs
        # recompute without the heads' output layers, input gradients of
        # every layer but the semantic layer 0 (pass_sem_grad False), and
        # every weight gradient
        bwd_macs = (fwd_macs - head_last) + (fwd_macs - sem0) + fwd_macs
        kernels["fused_pe_nerf_bwd"] = dict(
            shape=(f"x [{n1},3], extras [{n1},{de}], cotangents [{n1},16+3+1]"
                   f" -> dx, dextras, every weight and bias gradient"),
            source="cropnerf_tpu_torch/csrc/fused_pe_field_bwd.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:468",
            rel_err=bwd[n1][0], max_abs_err=bwd[n1][2], rows=bwd[n1][1],
            ragged_n=n1 - 77, ragged_rel_err=bwd[n1 - 77][0],
            ragged_rows=bwd[n1 - 77][1], deterministic=deterministic,
            vs_f32_kernel=max(vs_f32[0]), vs_f32_plain=max(vs_f32[1]),
            vs_f32_dx=(vs_f32[0][0], vs_f32[1][0]),
            passes=pass_ms(kb, 5), call_ms=cuda_ms(kb, 5),
            plain_ms=device_ms(pb, 3),
            flops=2.0 * n1 * bwd_macs,
            bytes=nbytes(xk, exk, *cotk, *wd) + nbytes(xk, exk, *wd))

        # K2 fused_pe_density: export trunk, 512 rays x 128 samples
        n2 = 512 * EXPORT_SIDE
        x2, _ = field_inputs(n2)
        k2 = lambda: fused_pe_density(x2, base, top, POS_FREQS)  # noqa: E731
        p2 = lambda: fused_pe_density_plain(x2, base, top, POS_FREQS)  # noqa: E731
        got, ref = k2(), p2()
        fwd_same = torch.equal(got, k2())
        xr = x2[:n2 - 45].contiguous()
        kernels["fused_pe_density"] = dict(
            shape=f"x [{n2},3] -> t [{n2},16]",
            source="cropnerf_tpu_torch/csrc/fused_pe_field.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_pe_field.py:124",
            rel_err=rel_err(got, ref), max_abs_err=abs_err(got, ref),
            ragged_n=n2 - 45,
            ragged_rel_err=rel_err(fused_pe_density(xr, base, top, POS_FREQS),
                                   fused_pe_density_plain(xr, base, top,
                                                          POS_FREQS)),
            deterministic=fwd_same,
            passes=pass_ms(k2, 10, FWD_PASSES), call_ms=cuda_ms(k2, 10),
            plain_ms=device_ms(p2, 5),
            flops=2.0 * n2 * trunk_macs,
            bytes=nbytes(x2, *base, *top) + nbytes(got))


    # K3 fused_mlp: the export's semantic and colour heads, same chunk
    heads = {"semantic head": sem_wbs, "colour head": col_wbs}
    kernels["fused_mlp"] = mlp_fwd_entry(heads, n2, dev, card,
                                         reports["fused_mlp_fwd"])
    fwd_regs = short_names(ptxas_registers(reports["fused_pe_field"]))
    fwd_spills = short_names(ptxas_spills(reports["fused_pe_field"]))
    for name in ("fused_pe_nerf", "fused_pe_nerf_bwd", "fused_pe_density"):
        kernels[name]["ms"] = kernels[name]["passes"]["total"]["median"]
    for name in ("fused_pe_nerf", "fused_pe_density"):
        k = kernels[name]
        k["registers"], k["spill_bytes"] = fwd_regs, fwd_spills
        log(f"[kernel] {name}: device ms over {BWD_WINDOWS} windows, median "
            f"(min-max): {fmt_passes(k['passes'])}; two runs bit-identical "
            f"{k['deterministic']}; registers {fwd_regs}, spill bytes "
            f"{fwd_spills}; {card}")
        check(k["deterministic"], f"{name} differs between two runs")
    k1b = kernels["fused_pe_nerf_bwd"]
    for name, k in kernels.items():
        if name in ("fused_pe_density_bwd", "fused_mlp", "fused_mlp_bwd"):
            continue                      # checked and logged by their entries
        k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        tol = GRAD_TOL if "rows" in k else TOL
        log(f"[kernel] {name}: {k['shape']}; err {k['rel_err']:.2e} "
            f"(ragged N={k['ragged_n']}: {k['ragged_rel_err']:.2e}), "
            f"tol {tol}; kernel {k['ms']:.4f} ms (wrapper call with weight "
            f"packing {k['call_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}); {card}")
        check(k["rel_err"] <= tol and k["ragged_rel_err"] <= tol,
              f"{name} disagrees with its plain version")
        if "rows" in k:
            log(f"[kernel] {name}: dx, dextras rows within {GRAD_TOL} of "
                f"max |plain| and relative L2 error: {k['rows']} (ragged "
                f"{k['ragged_rows']}); deterministic {k['deterministic']}; "
                f"against a float32 plain version: kernel "
                f"{k['vs_f32_kernel']:.2e}, bf16 plain {k['vs_f32_plain']:.2e} "
                f"(dx {k['vs_f32_dx'][0]:.2e} / {k['vs_f32_dx'][1]:.2e})")
            log(f"[kernel] {name}: device ms per pass over {BWD_WINDOWS} "
                f"windows, median (min-max): {fmt_passes(k['passes'])}; "
                f"{card}")
            check(k["deterministic"], f"{name} differs between two runs")
            for share, l2 in k["rows"] + k["ragged_rows"]:
                check(share >= ROW_SHARE and l2 <= GRAD_TOL,
                      f"{name}: dx/dextras rows {share:.4f}, L2 {l2:.2e}")
    regs = short_names(ptxas_registers(reports["fused_pe_field_bwd"]))
    spills = short_names(ptxas_spills(reports["fused_pe_field_bwd"]))
    k1b["registers"], k1b["spill_bytes"] = regs, spills
    log(f"[kernel] fused_pe_nerf_bwd: registers {regs}, spill bytes "
        f"{spills}; {card}")
    bwd_smem = {
        "with the heads": kfield.bwd_smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, color, sem, de=de, device=dev)[2]),
        "trunk only": kfield.bwd_smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, device=dev)[2], False),
        "fused_mlp semantic head": kmlp.net_layout(sem_wbs, False)[4],
        "fused_mlp colour head": kmlp.net_layout(col_wbs, False)[4],
        **{f"fused_mlp {label} (dx only; with dW)": (
            kmlp.net_layout(w, False)[4], kmlp.net_layout(w, True)[4])
           for label, w in wide.items()}}
    log(f"[build] fused_pe_field_bwd registers {regs}, spill bytes "
        f"{spills}; backward dynamic "
        f"shared memory per block: "
        + ", ".join(f"{k} {v} B" for k, v in bwd_smem.items()))
    n_unc = RAYS * m.num_nerf_samples_per_ray        # one BayesRays batch
    kernels["fused_pe_density_bwd"] = density_bwd_entry(
        base, top, trunk_macs, n_unc, dev, card, reports["fused_pe_field_bwd"])
    kernels["fused_mlp_bwd"] = mlp_bwd_entry(heads, n_unc, dev, card,
                                             reports["fused_mlp_bwd"])
    # K3 at -big's and -huge's heads, 128 and 256 wide: an export chunk,
    # each preset's BayesRays batch
    k3_heads = {
        "fused_mlp 128/256 wide": mlp_fwd_entry(wide, n2, dev, card,
                                                reports["fused_mlp_fwd"]),
        "fused_mlp_bwd 128/256 wide": mlp_bwd_entry(
            wide, wide_batch, dev, card, reports["fused_mlp_bwd"])}
    stream_k = stream_entries(dev, card, reports["fused_mlp_stream"])
    hash_k = hash_kernels(PRESETS["cropnerf"], dev, card,
                          reports["hash_encode"])

    lap("kernels")
    # ---- 4. the serving path ----------------------------------------------
    d = torch.randn((RAYS, 3), generator=torch.Generator().manual_seed(1))
    rb = RayBundle(
        origins=torch.tensor([[0.0, 0.0, 1.5]], device=dev).expand(RAYS, 3),
        directions=(d / d.norm(dim=-1, keepdim=True)).to(dev),
        nears=torch.zeros((RAYS,), device=dev),
        fars=torch.ones((RAYS,), device=dev),
        camera_idx=torch.zeros((RAYS,), dtype=torch.long, device=dev))
    rb = near_far_collider(rb, m.near_plane, m.far_plane)
    c2w = torch.eye(3, 4, device=dev)[None].clone()
    c2w[0, 2, 3] = 1.5
    f = float(RENDER_HW)
    cams = Cameras(c2w=c2w, fx=torch.full((1,), f, device=dev),
                   fy=torch.full((1,), f, device=dev),
                   cx=torch.full((1,), f / 2, device=dev),
                   cy=torch.full((1,), f / 2, device=dev),
                   width=torch.full((1,), RENDER_HW, device=dev),
                   height=torch.full((1,), RENDER_HW, device=dev))
    aabb = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]
    thresholds = export_thresholds(params, fcfg, g, dev)
    log(f"[path] export thresholds {thresholds}")
    render = make_render_fn(cfg)
    plain_m = dataclasses.replace(
        m, field=dataclasses.replace(m.field, mlp_impl="xla"))
    render_plain = make_render_fn(dataclasses.replace(cfg, model=plain_m))
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))

    path_kernels = (fused_pe_nerf, fused_pe_nerf_bwd, fused_pe_density,
                    fused_pe_density_bwd, fused_mlp, fused_mlp_bwd,
                    kmlp.fused_mlp_stream, kmlp.fused_mlp_stream_bwd)
    result = {}
    steps = {
        "forward": lambda: result.update(fwd=forward(params, rb, m)),
        "render": lambda: result.update(
            img=render(params, cams, 0, RENDER_HW, RENDER_HW)),
        "export": lambda: result.update(paths=export_and_write(
            params, m, aabb, out_dir, num_points_per_side=EXPORT_SIDE,
            render_rgb=True, **thresholds))}
    first_ms, step_launches = {}, {}
    for step, fn in steps.items():
        step_launches[step] = counted(path_kernels, lambda step=step, fn=fn:
                                      first_ms.update({step: wall_ms(fn)}))
        log(f"[path] launches of the {step}: {step_launches[step]}")
    launches = {name: sum(n[name] for n in step_launches.values())
                for name in step_launches["forward"]}
    check(all(v > 0 for k, v in launches.items() if "_bwd" not in k
              and "stream" not in k),
          f"a kernel of the path never launched: {launches}")
    check(all(v == 0 for k, v in launches.items() if "_bwd" in k),
          "serving recorded a graph and ran a backward")
    # K3 runs each head once an export chunk, on the wgmma kernels alone
    n_chunks = -(-EXPORT_SIDE ** 2 // EXPORT_RAYS)
    want_k3 = {"forward": 0, "render": 0, "export": 2 * n_chunks}
    for step, n in want_k3.items():
        got = step_launches[step]
        check(got["fused_mlp"] == n and got["fused_mlp_stream"] == 0,
              f"K3 launches of the {step}: {got}, expected fused_mlp {n} "
              f"and fused_mlp_stream 0")
    # steady state: the first calls above also grew the allocator's pools
    runs_ms = {step: [wall_ms(fn) for _ in range(REPEATS)]
               for step, fn in steps.items()}
    med_ms = {step: statistics.median(v) for step, v in runs_ms.items()}
    n_px = RENDER_HW * RENDER_HW
    from cropnerf_tpu_torch.export.ply import ply_vertex_count
    counts = {k: ply_vertex_count(p) for k, p in result["paths"].items()}
    for step, what, n_rays in (
            ("forward", f"{RAYS} rays", RAYS),
            ("render", f"{RENDER_HW}x{RENDER_HW}", n_px),
            ("export", f"{EXPORT_SIDE}^3 with colours, points {counts}",
             None)):
        rate = (f" ({n_rays / med_ms[step] * 1e3:.0f} rays/s)"
                if n_rays else "")
        log(f"[path] {step} {what}: median {med_ms[step]:.2f} ms of "
            f"{REPEATS}{rate}, runs "
            + ", ".join(f"{v:.2f}" for v in runs_ms[step])
            + f" ms; first call {first_ms[step]:.2f} ms; {card}")

    # ---- outputs: finite, right shapes, and the plain path agrees ---------
    fwd, img = result["fwd"], result["img"]
    for k in ("rgb", "accumulation", "depth", "semantics"):
        check(bool(torch.isfinite(fwd[k]).all()) and fwd[k].shape[0] == RAYS,
              f"forward {k}")
        check(bool(torch.isfinite(img[k]).all())
              and img[k].shape[:2] == (RENDER_HW, RENDER_HW), f"render {k}")
    fwd_p = forward(params, rb, plain_m)
    img_p = render_plain(params, cams, 0, RENDER_HW, RENDER_HW)
    agree = {}
    for label, a, b in (("forward", fwd, fwd_p), ("render", img, img_p)):
        for k in ("rgb", "accumulation", "semantics"):
            agree[f"{label} {k}"] = rel_err(a[k], b[k])
        dd = (a["depth"] - b["depth"]).abs()
        agree[f"{label} depth equal"] = (
            dd <= 1e-3 * b["depth"].abs() + 1e-4).float().mean().item()
    paths_p = export_and_write(params, plain_m, aabb, out_dir / "plain",
                               num_points_per_side=EXPORT_SIDE,
                               render_rgb=True, **thresholds)
    counts_p = {k: ply_vertex_count(p) for k, p in paths_p.items()}
    log(f"[check] kernel path vs plain path: "
        + ", ".join(f"{k} {v:.3e}" for k, v in agree.items())
        + f"; export points {counts} vs plain {counts_p}")
    for k, v in agree.items():
        if k.endswith("depth equal"):
            check(v >= 0.99, f"{k}: {v:.4f} < 0.99")
        else:
            check(v <= 2 * TOL, f"{k}: {v:.3e} > {2 * TOL}")
    check(counts["density"] > counts["semantic"] > 0, f"export {counts}")
    for k in counts:
        check(abs(counts[k] - counts_p[k]) <= 0.01 * counts_p[k] + 10,
              f"export {k}: {counts[k]} points vs plain {counts_p[k]}")

    all_kernels = path_kernels + (hash_encode, hash_encode_bwd, fused_pe_mlp,
                                  fused_pe_mlp_stream, fused_pe_mlp_bwd,
                                  fused_pe_mlp_stream_bwd,
                                  render_weights_cuda)
    pe_k = pe_mlp_entries(cfg, dev, card, reports, all_kernels)
    pe_wide = pe_mlp_wide_entries(dev, card, reports, all_kernels)
    k6 = transmittance_entry(dev, card, all_kernels)
    hash_path, hash_forward = hash_serving(dev, card, rb, cams, aabb, out_dir,
                                           all_kernels)

    lap("serving path")
    # ---- 5. the training path ---------------------------------------------
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import (make_eval_batch_fn,
                                               make_train_step, train_loss)
    from tools.hash_bwd_real_step import BANK, synthetic_bank
    t0 = time.perf_counter()
    n_img, bh, bw = BANK
    bank = synthetic_bank(dev)
    R = cfg.train_num_rays_per_batch
    log(f"[train] bank {n_img} x {bh}x{bw} on the card as uint8 "
        f"({nbytes(bank.rgb, bank.mask) / 2**20:.1f} MiB), built in "
        f"{time.perf_counter() - t0:.1f} s; {R} rays a step")

    # one step on the kernel path and on the plain path, same draws
    plain_cfg = dataclasses.replace(cfg, model=plain_m)
    one = {}
    for label, c in (("kernel", cfg), ("plain", plain_cfg)):
        st = create_train_state(c, n_img, torch.Generator().manual_seed(0), dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        idx = torch.randint(0, bank.num_pixels, (R,), generator=gen,
                            device=dev)
        loss, _ = train_loss(st.params, bank, idx, 0, c, gen)
        loss.backward()
        one[label] = (loss.item(), {k: p.grad.clone() for k, p in
                                    st.params.named_parameters()})
        del st
    (l_k, g_k), (l_p, g_p) = one["kernel"], one["plain"]
    leaf_err = {k: rel_err(g_k[k], g_p[k]) for k in g_p}
    worst = max(leaf_err, key=leaf_err.get)
    log(f"[train] one step, kernel path vs plain path: loss {l_k:.6f} vs "
        f"{l_p:.6f} (rel {abs(l_k - l_p) / abs(l_p):.2e}); gradient leaves "
        f"within {GRAD_TOL} of max: {sum(v <= GRAD_TOL for v in leaf_err.values())}"
        f"/{len(leaf_err)}, worst {worst} {leaf_err[worst]:.2e}")
    check(math.isfinite(l_k) and abs(l_k - l_p) <= 2e-2 * abs(l_p),
          f"train loss {l_k} vs plain {l_p}")
    for k, v in leaf_err.items():
        check(bool(torch.isfinite(g_k[k]).all()) and v <= GRAD_TOL,
              f"train gradient {k}: {v:.3e}")
    del one, g_k, g_p

    # the training path: a first step and TRAIN_STEPS timed steps
    state = create_train_state(cfg, n_img, torch.Generator().manual_seed(0),
                               dev)
    train_step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(4)
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    metrics = {}

    def run_train():
        metrics.update(train_step(state, bank, gen)[1])

    for fn in path_kernels:
        fn.launches = 0
    train_first_ms = wall_ms(run_train)
    train_runs_ms = [wall_ms(run_train) for _ in range(TRAIN_STEPS)]
    train_launches = {fn.__name__: fn.launches for fn in path_kernels}
    n_steps = 1 + TRAIN_STEPS
    log(f"[train] launches on the training path ({n_steps} steps): "
        f"{train_launches}")
    check(train_launches["fused_pe_nerf"] == n_steps
          and train_launches["fused_pe_nerf_bwd"] == n_steps,
          f"K1 forward/backward launches {train_launches} != {n_steps} steps")
    loss_now = metrics["loss"].item()
    changed = sum(not torch.equal(v, before[k])
                  for k, v in state.params.state_dict().items())
    check(math.isfinite(loss_now) and state.step == n_steps,
          f"training loss {loss_now}, step {state.step}")
    check(changed == len(before),
          f"{len(before) - changed} parameter tensors did not change")
    train_med = statistics.median(train_runs_ms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_train()
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_m = {k: v.item() for k, v in make_eval_batch_fn(cfg)(
        state.params, bank, gen).items()}
    check(all(math.isfinite(v) for v in eval_m.values()), f"eval {eval_m}")
    log(f"[train] step: median {train_med:.2f} ms of {TRAIN_STEPS} "
        f"({R / train_med * 1e3:.0f} rays/s), runs "
        + ", ".join(f"{v:.2f}" for v in train_runs_ms)
        + f" ms; first step {train_first_ms:.2f} ms; peak device memory "
        f"{train_peak:.2f} GiB; loss {loss_now:.5f}, "
        f"psnr {metrics['psnr'].item():.3f}; eval batch {eval_m}; {card}")
    steps["train step"] = run_train
    hash_train, hash_step = hash_training(
        dev, card, bank, all_kernels, hash_k["hash_encode"]["gather_rate"])
    real = hash_train["hash_encode_real_step"]
    hash_k["hash_encode"]["real_step"] = real_f = real["fwd"]
    hash_k["hash_encode_bwd"]["real_step"] = real_b = real["bwd"]
    log(f"[kernel] hash_encode, one cropnerf training step's three calls: "
        f"{hash_k['hash_encode']['ms']:.4f} ms on uniform positions, "
        f"{real_f['ms']:.4f} ms ({real_f['ms_min']:.4f}-"
        f"{real_f['ms_max']:.4f}) on the step's own ("
        + ", ".join(f"[{c['n']},3] x {c['levels']} levels {c['ms']:.4f} ms, "
                    f"bit-identical {c['bitwise']}, "
                    f"{c['sectors_per_lookup']:.3f} sectors a lookup, "
                    f"{c['sectors_at_index_select_rate_ms']:.4f} ms at "
                    "index_select's gather rate" for c in real_f["calls"])
        + f"); its sectors at index_select's gather rate "
        f"{real_f['sectors_at_index_select_rate_ms']:.4f} ms against "
        f"{hash_k['hash_encode']['sectors_at_index_select_rate_ms']:.4f} ms "
        f"on uniform positions (no floor: the kernel moves sectors faster); "
        f"{card}")
    log(f"[kernel] hash_encode_bwd, one cropnerf training step's three "
        f"calls: {hash_k['hash_encode_bwd']['ms']:.4f} ms on uniform "
        f"positions, {real_b['ms']:.4f} ms ({real_b['ms_min']:.4f}-"
        f"{real_b['ms_max']:.4f}) on the step's own ("
        + ", ".join(f"[{c['n']},3] x {c['levels']} levels {c['ms']:.4f} ms, "
                    f"err dtable {c['dtable_err']:.2e} dpos "
                    f"{c['dpos_err']:.2e}" for c in real_b["calls"])
        + f"); {card}")
    steps["cropnerf forward"] = hash_forward
    steps["cropnerf train step"] = hash_step

    lap("training path")
    # ---- 5b. the BayesRays pass and the uncertainty-filtered paths -------
    unc, unc_steps = uncertainty_phase(dev, card, bank, cams, all_kernels)
    steps.update(unc_steps)

    lap("BayesRays")
    # ---- 5c. the fused-proposal path: K5 serving, training, depth cloud --
    pf_info, pf_steps = propfused_phase(dev, card, bank, rb, cams, all_kernels)
    steps.update(pf_steps)

    lap("propfused")
    # ---- 5c'. cropnerf-mxu-q, published and with fused proposals (K5's
    # wide route) ------------------------------------------------------------
    mq_info, mq_steps = mxuq_phase(dev, card, bank, rb, cams, all_kernels)
    steps.update(mq_steps)
    mq_pf = mq_info["propfused"]

    lap("mxuq")
    # ---- 5c''. [prop256]: -q's proposal nets 256 wide and -huge's 256-wide
    # semantic head (the stream route of K5 and K3) ---------------------------
    p256_work = Path(tempfile.mkdtemp(prefix="chip_smoke_prop256_"))
    p256, p256_steps = prop256_phase(dev, card, bank, rb, cams, all_kernels,
                                     p256_work)
    steps.update(p256_steps)

    lap("prop256")
    # ---- 5c'''. [w512]: a 512-wide trunk, semantic head and PE proposal
    # nets (the tile kernels' wide programs) -------------------------------
    w512_work = Path(tempfile.mkdtemp(prefix="chip_smoke_w512_"))
    w512, w512_steps, w512_k = w512_phase(dev, card, bank, rb, cams,
                                          all_kernels, reports, w512_work)
    steps.update(w512_steps)
    shutil.rmtree(w512_work)

    lap("w512")
    # ---- 5c''''. [w1024]: a 1024-wide trunk (K1 and K2 in width class 2)
    # and mip-NeRF 360's 4 x 256 proposal nets ----------------------------
    w1024_work = Path(tempfile.mkdtemp(prefix="chip_smoke_w1024_"))
    w1024, w1024_steps, w1024_k = w1024_phase(dev, card, bank, rb, cams,
                                              all_kernels, reports, w1024_work)
    steps.update(w1024_steps)
    shutil.rmtree(w1024_work)

    lap("w1024")
    # ---- 5d. the trainer loop and the CLI ---------------------------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    cli_info = cli_phase(dev, card, all_kernels,
                         {"cropnerf": hash_train["median_ms"],
                          "cropnerf-mxu": train_med}, work)

    lap("cli")
    # ---- 5e. the counting pipeline through the CLI ------------------------
    count_info, count_steps = count_phase(dev, card, all_kernels, work)
    steps.update(count_steps)

    lap("count")
    # ---- 5f. two ranks: the data-parallel steps and train --multichip -----
    ddp_info = ddp_phase(dev, card, bank, work)

    lap("ddp")
    # ---- 5g. the viewer ----------------------------------------------------
    viewer_info = viewer_phase(card, work / "cropnerf-mxu",
                               work / "cropnerf-mxu" / "count_exports")

    lap("viewer")
    # ---- 5h. rematerialisation: -big, -huge, semantic-nerf; the watchdog --
    remat_info = remat_phase(dev, card, bank, all_kernels, work)

    lap("remat")
    # ---- 5i. K3's wide heads on their paths: -big and -huge ---------------
    wide_info, wide_steps = wide_phase(dev, card, bank, all_kernels, work)
    steps.update(wide_steps)
    shutil.rmtree(work)
    shutil.rmtree(p256_work)

    lap("wide")
    # ---- 6. where the time goes: one traced call of each path step ------
    # (after one untraced call: the phases between a step's own calls and
    # its trace may have pushed its kernels' layouts out of their caches)
    breakdown = {}
    for step, fn in steps.items():
        fn()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_ms = wall_ms(fn)
        # device-side rows only (kernels, copies): the host operators that
        # launched them report the same time again
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda o: -o[1])
        busy_ms = sum(o[1] for o in ops)
        breakdown[step] = {"traced_ms": step_ms, "device_busy_ms": busy_ms,
                           "top": ops[:8]}
        log(f"[trace] {step}: {step_ms:.2f} ms traced, device busy "
            f"{busy_ms:.2f} ms ({busy_ms / step_ms:.0%}); {card}")
        for key, ms, count in ops[:8]:
            log(f"[trace]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")

    lap("trace")
    # ---- 7. report ---------------------------------------------------------
    unc_mxu = unc["cropnerf-mxu"]["launches"]
    by_path = {name: {"serving": {step: n[name]
                                  for step, n in step_launches.items()},
                      "train": train_launches[name],
                      "uncertainty": unc_mxu[name]} for name in kernels}
    # each kernel's main path: K1 the training step, K2 and K3 forward the
    # export, their backwards the BayesRays pass
    main_launches = {name: (train_launches[name]
                            if name.startswith("fused_pe_nerf") else
                            unc_mxu[name] if name.endswith("_bwd") else
                            launches[name]) for name in kernels}
    # the stream route's kernels: launches on the [prop256] phase's paths;
    # each kernel's main path there
    p256_paths = {name: {path: p256[path]["launches"].get(name, 0)
                         for path in P256_PATHS} for name in stream_k}
    check(all(p256_paths[name][P256_MAIN[name]] > 0 for name in stream_k),
          f"a stream kernel never launched on its path: {p256_paths}")
    line = {"kernels": [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=main_launches[name],
        launches_by_path=by_path[name], max_abs_err=k["max_abs_err"],
        rel_err=k["rel_err"], ms=k["ms"], call_ms=k["call_ms"],
        plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], card=card,
        **{key: k[key] for key in ("passes", "with_dw_passes", "registers",
                                   "spill_bytes", "kernel_route", "by_head",
                                   "deterministic", "with_dw_ms")
           if key in k})
        for name, k in kernels.items()] + [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=p256_paths[name][P256_MAIN[name]],
        launches_by_path={"[prop256]": p256_paths[name]},
        max_abs_err=k["max_abs_err"], rel_err=k["rel_err"], ms=k["ms"],
        call_ms=k["call_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"], card=card,
        kernel_route=k["kernel_route"], registers=k["registers"],
        spill_bytes=k["spill_bytes"], by_net=k["by_net"],
        **{key: k[key] for key in ("with_dw_ms",) if key in k})
        for name, k in stream_k.items()] + [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=sum(n[counter] for path, n in wide_info["launches"].items()
                     if not path.startswith("cli")),
        launches_by_path={path: n[counter]
                          for path, n in wide_info["launches"].items()},
        max_abs_err=k["max_abs_err"], rel_err=k["rel_err"], ms=k["ms"],
        call_ms=k["call_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"], card=card,
        kernel_route=k["kernel_route"], by_head=k["by_head"],
        registers=k["registers"], spill_bytes=k["spill_bytes"],
        **{key: k[key] for key in ("deterministic", "with_dw_ms") if key in k})
        for name, k in k3_heads.items()
        for counter in [name.split()[0]]] + [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=hash_train["launches"][name],
        launches_by_path={
            "serving": {step: n[name]
                        for step, n in hash_path["launches"].items()},
            "train": hash_train["launches"][name],
            "no_update_step": hash_train["no_update_step_launches"][name],
            "uncertainty": unc["cropnerf"]["launches"][name]},
        max_abs_err=k["max_abs_err"], rel_err=k["rel_err"], ms=k["ms"],
        call_ms=k["call_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"], card=card,
        by_shape=k["by_shape"],
        **{key: k[key] for key in ("real_step", "ms_min", "ms_max",
                                   "gather_rate",
                                   "sectors_at_index_select_rate_ms",
                                   "fwd_bitwise") if key in k})
        for name, k in hash_k.items()] + [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=pf_info["train"]["launches"][name],
        launches_by_path={
            "forward": pf_info["forward"]["launches"][name],
            "render": pf_info["render"]["launches"][name],
            "train": pf_info["train"]["launches"][name],
            "pointcloud": pf_info["pointcloud"]["launches"][name]},
        max_abs_err=k["max_abs_err"], rel_err=k["rel_err"], ms=k["ms"],
        call_ms=k["call_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"], card=card,
        registers=k["registers"], by_net=k["by_net"],
        **{key: k[key] for key in ("spill_bytes", "ms_min", "ms_max")
           if key in k})
        for name, k in pe_k.items()] + [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=mq_pf["train"]["launches"][counter],
        launches_by_path={path: mq_pf[path]["launches"][counter]
                          for path in ("forward", "render", "train",
                                       "pointcloud")},
        max_abs_err=k["max_abs_err"], rel_err=k["rel_err"], ms=k["ms"],
        call_ms=k["call_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None, shape=k["shape"], card=card,
        kernel_route="wgmma (PE variant)", registers=k["registers"],
        spill_bytes=k["spill_bytes"], by_net=k["by_net"])
        for name, k in pe_wide.items()
        for counter in [name.split()[0]]] + [dict(
        name=f"{name} {tag}", route="cuda", source=k["source"],
        replaces=k["replaces"], launches=k["launches"],
        launches_by_path=k["launches_by_path"], max_abs_err=k["max_abs_err"],
        rel_err=k["rel_err"], ms=k["ms"], call_ms=k["call_ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
        library_ms=None, shape=k["shape"], card=card,
        registers=k["registers"], spill_bytes=k["spill_bytes"],
        **{key: k[key] for key in ("passes", "with_dw_passes", "with_dw_ms",
                                   "deterministic", "errors", "rows",
                                   "kernel_route", "by_net") if key in k})
        for tag, ks in (("[w512]", w512_k), ("[w1024]", w1024_k))
        for name, k in ks.items()] + [dict(
        name="render_weights_cuda", route="cuda", source=k6["source"],
        replaces=k6["replaces"], launches=k6["launches"],
        launches_by_path={"its entry point at K6_SHAPES": k6["launches"],
                          "model paths": 0},
        max_abs_err=k6["max_abs_err"], rel_err=k6["rel_err"], ms=k6["ms"],
        call_ms=k6["call_ms"], plain_ms=k6["plain_ms"],
        bound_ms=k6["bound_ms"], bound_by=k6["bound_by"], library_ms=None,
        shape=k6["shape"], card=card, by_shape=k6["by_shape"])],
        "path": {"card": card, "repeats": REPEATS, "median_ms": med_ms,
                 "runs_ms": runs_ms, "first_ms": first_ms,
                 "forward_rays_per_s": RAYS / med_ms["forward"] * 1e3,
                 "render_rays_per_s": n_px / med_ms["render"] * 1e3,
                 "export_points": counts},
        "train": {"card": card, "rays": R, "steps": TRAIN_STEPS,
                  "median_ms": train_med, "runs_ms": train_runs_ms,
                  "first_ms": train_first_ms, "peak_gib": train_peak,
                  "rays_per_s": R / train_med * 1e3, "loss": loss_now,
                  "vs_plain_loss_rel": abs(l_k - l_p) / abs(l_p),
                  "vs_plain_grad_worst": [worst, leaf_err[worst]]},
        "cropnerf_path": hash_path,
        "cropnerf_train": hash_train,
        "uncertainty": unc,
        "bwd_kernels": {name: kernels[name] for name in
                        ("fused_pe_density_bwd", "fused_mlp_bwd")},
        "propfused": pf_info,
        "mxuq": mq_info,
        "prop256": p256,
        "w512": w512,
        "w1024": w1024,
        "cli": cli_info,
        "count": count_info,
        "ddp": ddp_info,
        "viewer": viewer_info,
        "remat": remat_info,
        "wide": wide_info,
        "trace": breakdown}
    for entry in line["kernels"]:
        entry["launches_by_path"]["cli"] = {
            f"{preset} {cmd}": n.get(entry["name"], 0)
            for preset in ("cropnerf", "cropnerf-mxu")
            for cmd, n in cli_info[preset]["launches"].items()}
        entry["launches_by_path"]["count"] = {
            f"{preset} {cmd}": n.get(entry["name"], 0)
            for preset in ("cropnerf", "cropnerf-mxu")
            for cmd, n in count_info[preset]["launches"].items()}
        entry["launches_by_path"]["ddp"] = {
            path: n.get(entry["name"], 0)
            for path, n in ddp_info["launches"].items()}
        entry["launches_by_path"]["remat"] = {
            path: n.get(entry["name"], 0)
            for path, n in remat_info["launches"].items()}
    print(json.dumps(line), flush=True)
    shutil.rmtree(out_dir)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank":
        rank_main(Path(sys.argv[2]))
    else:
        main()
