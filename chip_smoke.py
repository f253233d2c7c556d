#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cropnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

1. builds the CUDA kernels from cropnerf_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, started together) and prints each kernel's
   registers, shared memory and spills;
2. prints the card (torch and nvidia-smi: name, power limit);
3. holds every kernel against its plain PyTorch version at the shapes the
   serving and training paths give it and at a ragged N, and times both:
   for cropnerf-mxu K1 forward and backward (the backward against autograd
   of the plain version), K2 and K3 forward and backward (the backwards at
   the BayesRays batch, with and without weight gradients); for cropnerf
   (the hash-grid field, the CLI default) the hash-grid encode K4 forward
   and backward at the field's and both proposal nets' shapes, a ragged N
   and a small dense [L, T, F] table;
4. drives the serving paths with random weights from a seeded
   torch.Generator at full published widths: forward at 4096 rays, a
   256x256 render (two 32,768-ray chunks) and a 128^3 volume export with
   colours, with the launch counts zeroed just before and read just after;
   then runs the same calls with the kernels' plain versions and compares.
   cropnerf-mxu first, then cropnerf, whose launch counts are checked
   exactly for each call;
5. drives the training paths: a pixel bank of 32 synthetic 1200x800
   images resident on the card, 4096 rays a step; one step on the kernel
   path against one on the plain path from the same parameters and draws,
   then a first step and TRAIN_STEPS timed steps with the launch counts
   zeroed before and read after; for cropnerf then one step between
   proposal updates (the proposal nets run without a graph);
5b. drives the BayesRays pass on the same bank ([uncertainty] lines): the
   Hessian at lod 8 over UNC_BATCHES batches of 4096 rays, semantics
   channel, for cropnerf-mxu (K2 and K3 forward and backward, dx only; then
   one rgb-channel batch) and cropnerf (K4 forward and its dpos-only
   backward), with exact launch counts and the grid held against the plain
   path; then the per-ray uncertainty and a 256x256 render filtered at
   uncertainty 0.5 through make_render_fn's density hook;
6. traces one forward, render, export and training step of cropnerf-mxu,
   one forward and training step of cropnerf and one BayesRays batch of
   each with torch.profiler, and prints the device time of the busiest
   operations and the device's busy share;
7. prints one JSON line of kernel numbers, the nvidia-smi card line, and
   the status line last.

Any failed phase raises and the script exits non-zero.  It needs a CUDA
device and the repository beside it; without either it fails before it
prints a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
REPEATS = 5              # timed runs of each path step after its first call
TRAIN_STEPS = 20         # timed training steps after the first
BANK = (32, 800, 1200)   # training images, height, width (as bench.py)
UNC_LOD = 8              # BayesRays grid: (2^8+1)^3 cells (the CLI default)
UNC_BATCHES = 8          # BayesRays ray batches of RAYS rays
UNC_THRESHOLD = 0.5      # uncertainty filter of the filtered render
UNC_VIEW_SAMPLES = 1000  # the viewer's uncertainty normaliser (its default)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    such as a wrapper packing its weights."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (only is None or only in e.key)]
    check(bool(rows) and sum(rows) > 0, f"the profiler saw no device time "
          f"for {only or 'the plain version'}")
    return sum(rows) / 1e3 / iters


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


def row_agreement(got, ref):
    """(share of rows whose largest error is within GRAD_TOL · max |ref|,
    relative L2 error) of a per-row gradient such as dx."""
    row_err = (got - ref).abs().amax(dim=1) / ref.abs().max().clamp_min(1e-12)
    return ((row_err <= GRAD_TOL).float().mean().item(),
            ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item())


def weight_grad_errors(got, ref):
    """(max error / max |ref|, relative L2) over weight and bias gradient
    pairs, the worst of each."""
    pairs = list(zip(got, ref))
    if not pairs:
        return 0.0, 0.0
    return (max(rel_err(a, b) for a, b in pairs),
            max(((a - b).norm() / b.norm().clamp_min(1e-12)).item()
                for a, b in pairs))


def weight_grads_ok(w_err, w_l2, n) -> bool:
    """Weight and bias gradients within GRAD_TOL in relative L2, and within
    GRAD_TOL of max |plain| over 1000 rows or more: a relu unit that flips
    in one row moves that row's outer product by up to ~10 % of the largest
    entry when the sum runs over a single 128-row tile."""
    return w_l2 <= GRAD_TOL and (n < 1000 or w_err <= GRAD_TOL)


def ptxas_registers(report: str) -> dict:
    """Registers per kernel entry in an ``nvcc -Xptxas -v`` report."""
    regs, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry is not None:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
    return regs


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def unported_bounds(presets) -> dict:
    """Bounds of the TPU kernels not ported yet (K5, K6), from the JAX
    kernels' shapes at the configuration that would reach them; no kernel
    runs here, so they are not measured.  float32 activations as the JAX
    package keeps them; tensor-core bf16 peak for products."""
    out = {}
    m = presets["cropnerf-mxu"]             # K5: its proposal net 0, fused
    p0 = m.model.proposal_fields[0]
    n = m.train_num_rays_per_batch * m.model.num_proposal_samples_per_ray[0]
    dims = ([3 * (1 + 2 * p0.pe_freqs)] + [p0.hidden_dim] * (p0.num_layers - 1)
            + [1])
    t_ops = 2.0 * n * mlp_macs(dims) / PEAK_BF16_FLOPS * 1e3
    t_bytes = n * (3 + 1) * 4 / PEAK_BYTES * 1e3
    out["fused_pe_mlp"] = dict(
        shape=f"x [{n},3] -> {'->'.join(map(str, dims))} (cropnerf-mxu "
              "proposal net 0 with mlp_impl='pallas-fused', forward)",
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    r, smp = m.train_num_rays_per_batch, m.model.num_nerf_samples_per_ray
    t_bytes = 3 * r * smp * 4 / PEAK_BYTES * 1e3   # density, deltas -> weights
    out["transmittance"] = dict(
        shape=f"density, deltas [{r},{smp}] -> weights (cropnerf-mxu final "
              "level; wired into no model path)",
        bound_ms=max(t_bytes, 6 * r * smp / PEAK_F32_FLOPS * 1e3),
        bound_by="bytes")
    return out


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


def rows_touched(pos, layout) -> int:
    """Table rows that these positions read: the corners of their cells at
    every level, each counted once (the data-dependent part of K4's
    bytes)."""
    from cropnerf_tpu_torch.ops.hashgrid import _hash3
    res, offsets, dense, t = layout
    rows = []
    for r, off, d in zip(res, offsets, dense):
        base = torch.floor(pos * r).long()
        if d:
            base = base.clamp(0, r - 1)
        for corner in range(8):
            c = base + torch.tensor([corner & 1, (corner >> 1) & 1,
                                     (corner >> 2) & 1], device=pos.device)
            idx = ((c[:, 0] * (r + 1) + c[:, 1]) * (r + 1) + c[:, 2] if d
                   else _hash3(c[:, 0], c[:, 1], c[:, 2], t))
            rows.append(torch.unique(off + idx))
    return int(torch.unique(torch.cat(rows)).numel())


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
    per = {}
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
        check(k["fwd_err"] <= HASH_TOL and k["dtable_err"] <= HASH_TOL
              and k["dpos_err"] <= DPOS_TOL,
              f"hash_encode {label} disagrees with its plain version")
        if (label, n, gc) in path:
            touched = rows_touched(pos, layout)
            k.update(touched=touched,
                     ms=device_ms(kf, 20, KERNEL_NS), call_ms=cuda_ms(kf, 20),
                     plain_ms=device_ms(pf, 3),
                     bwd_ms=device_ms(kb, 10, KERNEL_NS),
                     bwd_call_ms=cuda_ms(kb, 10), bwd_plain_ms=device_ms(pb, 3))
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
                f"(call {k['call_ms']:.4f}), plain {k['plain_ms']:.4f} ms, "
                f"bound {k['bound_ms']:.4f} ms (bytes; {touched} of "
                f"{k['rows']} rows read; with the whole table read "
                f"{k['whole_table_bound_ms']:.4f} ms); backward "
                f"{k['bwd_ms']:.4f} ms (call with the zeroed gradient "
                f"{k['bwd_call_ms']:.4f}), plain {k['bwd_plain_ms']:.4f} ms, "
                f"bound {k['bwd_bound_ms']:.4f} ms (bytes); {card}")
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


def hash_training(dev, card, bank, kernels):
    """cropnerf training at 4096 rays on the resident bank: one step on the
    kernel path against the plain path, a first step and TRAIN_STEPS timed
    steps (all proposal-update steps: 3 forward and 3 backward encodes
    each), then one step between proposal updates (3 forward, 1 backward)
    and the peak memory of an update step.  Returns (numbers for the JSON
    line, the step call for the trace)."""
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
            "vs_plain_grad_worst": [worst, leaf_err[worst]]}
    return info, run_train


# ---- the BayesRays slice: K2 and K3 backward, the [uncertainty] phase ------

def density_bwd_entry(base, top, trunk_macs, n, dev, card, report) -> dict:
    """K2 backward (the trunk-only mode of csrc/fused_pe_field_bwd.cu)
    against autograd through the plain version at N = 128, 1000, n - 77 and
    n, with the weight gradients and with dx alone (the BayesRays pass's
    variant, which the entry's ms and bound are for)."""
    from cropnerf_tpu_torch.models.vanilla import POS_FREQS
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kf
    g = torch.Generator(device=dev).manual_seed(11)
    wd = [w.detach() for w in (*base, *top)]
    nb = len(base)
    x_all = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
    cot_all = torch.randn((n, top[-2].shape[1]), generator=g, device=dev)

    def plain(xb, cot, need_dw):
        leaves = [xb.clone().requires_grad_(True)] + [
            w.clone().requires_grad_(need_dw) for w in wd]
        with torch.enable_grad():
            out = kf.fused_pe_density_plain(leaves[0], leaves[1:nb + 1],
                                            leaves[nb + 1:], POS_FREQS)
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
            check(share >= ROW_SHARE and l2 <= GRAD_TOL
                  and weight_grads_ok(w_err, w_l2, m),
                  f"fused_pe_density_bwd N={m} dW={need_dw}: rows {share:.4f}"
                  f", dx L2 {l2:.2e}, weights {w_err:.2e} (L2 {w_l2:.2e})")
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
        ms=device_ms(lambda: kernel(xb, cot, False), 10, KERNEL_NS),
        call_ms=cuda_ms(lambda: kernel(xb, cot, False), 10),
        plain_ms=device_ms(lambda: plain(xb, cot, False), 3),
        with_dw_ms=device_ms(lambda: kernel(xb, cot, True), 5, KERNEL_NS),
        with_dw_plain_ms=device_ms(lambda: plain(xb, cot, True), 3),
        # recompute and input gradients (dx only); the weight gradient adds
        # a third product
        flops=2.0 * n * trunk_macs * 2,
        bytes=nbytes(xb, cot, xb, *wd))
    k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
    k["with_dw_bound_ms"] = bound(3.0 * n * trunk_macs * 2,
                                  nbytes(xb, cot, xb, *wd) + nbytes(*wd))[0]
    k["registers"] = ptxas_registers(report)
    log(f"[kernel] fused_pe_density_bwd: {k['shape']}; dx rows within "
        f"{GRAD_TOL} of max and L2 by case: "
        + ", ".join(f"{c}: {v['rows']:.5f}/{v['dx_l2']:.2e} (weights "
                    f"{v['w_err']:.2e})" for c, v in k["cases"].items())
        + f"; dx only {k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}); with dW {k['with_dw_ms']:.4f} ms, plain "
        f"{k['with_dw_plain_ms']:.4f} ms, bound {k['with_dw_bound_ms']:.4f} "
        f"ms; {card}")
    return k


def mlp_bwd_entry(heads, n, dev, card, report) -> dict:
    """K3 backward on the vanilla field's two heads at the BayesRays batch
    (N = n) and a ragged N, with and without weight gradients, against
    autograd through the plain version.  The entry's ms and bound are the
    two heads' dx-only backwards summed (the semantics path runs the
    semantic head, the rgb path the colour head)."""
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as km
    g = torch.Generator(device=dev).manual_seed(12)
    per = {}
    for label, wbs in heads.items():
        wd = [w.detach() for w in wbs]
        din, dout = wd[0].shape[0], wd[-2].shape[1]
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
        for m in (n, n - 3):
            xb, cot = x_all[:m].contiguous(), cot_all[:m].contiguous()
            for need_dw in (False, True):
                got, ref = kernel(xb, cot, need_dw), plain(xb, cot, need_dw)
                share, l2 = row_agreement(got[0], ref[0])
                w_err, w_l2 = weight_grad_errors(got[1:], ref[1:])
                errs[f"N={m}{' with dW' if need_dw else ' dx only'}"] = dict(
                    rows=share, dx_l2=l2, w_err=w_err, w_l2=w_l2,
                    abs=max(abs_err(a, b) for a, b in zip(got, ref)))
                check(share >= ROW_SHARE and l2 <= GRAD_TOL
                      and weight_grads_ok(w_err, w_l2, m),
                      f"fused_mlp_bwd {label} N={m} dW={need_dw}: rows "
                      f"{share:.4f}, dx L2 {l2:.2e}, weights {w_err:.2e}")
                if m == n:
                    again = kernel(xb, cot, need_dw)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"fused_mlp_bwd {label} differs between two runs")
        xb, cot = x_all, cot_all
        dims = [din] + [w.shape[1] for w in wd[0::2]]
        macs = mlp_macs(dims)
        hidden = macs - dims[-2] * dims[-1]
        k = dict(errs=errs, ms=device_ms(lambda: kernel(xb, cot, False), 20,
                                         KERNEL_NS),
                 call_ms=cuda_ms(lambda: kernel(xb, cot, False), 20),
                 plain_ms=device_ms(lambda: plain(xb, cot, False), 5),
                 with_dw_ms=device_ms(lambda: kernel(xb, cot, True), 10,
                                      KERNEL_NS),
                 with_dw_plain_ms=device_ms(lambda: plain(xb, cot, True), 5),
                 dims=dims)
        k["bound_ms"], k["bound_by"] = bound(2.0 * n * (hidden + macs),
                                             nbytes(xb, cot, xb, *wd))
        # the weight gradients add one product and write dW once
        k["with_dw_bound_ms"] = bound(2.0 * n * (hidden + 2 * macs),
                                      nbytes(xb, cot, xb, *wd) + nbytes(*wd))[0]
        per[label] = k
        log(f"[kernel] fused_mlp_bwd {label} [{n},{din}]->"
            f"{'->'.join(map(str, dims[1:]))}: rows/L2/weights by case "
            + ", ".join(f"{c}: {v['rows']:.5f}/{v['dx_l2']:.2e}/"
                        f"{v['w_err']:.2e}" for c, v in errs.items())
            + f"; dx only {k['ms']:.4f} ms (call {k['call_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); with dW {k['with_dw_ms']:.4f} ms, plain "
            f"{k['with_dw_plain_ms']:.4f} ms, bound "
            f"{k['with_dw_bound_ms']:.4f} ms; {card}")
    regs = {e: r for e, r in ptxas_registers(report).items() if "bwd" in e}
    spills = [line.strip() for line in report.splitlines() if "spill" in line]
    log(f"[build] fused_mlp registers (backward entries) {regs}; "
        + "; ".join(spills))
    vals = list(per.values())
    return dict(
        shape=(f"semantic head [{n},15]->64->1 and colour head [{n},74]->64"
               f"->3, g -> dx (BayesRays: no weight gradient)"),
        source="cropnerf_tpu_torch/csrc/fused_mlp.cu",
        replaces="cropnerf_tpu/ops/pallas/fused_mlp.py:45",
        by_head=per, registers=regs,
        max_abs_err=max(e["abs"] for k in vals for e in k["errs"].values()),
        rel_err=max(e["dx_l2"] for k in vals for e in k["errs"].values()),
        ms=sum(k["ms"] for k in vals), call_ms=sum(k["call_ms"] for k in vals),
        plain_ms=sum(k["plain_ms"] for k in vals),
        bound_ms=sum(k["bound_ms"] for k in vals), bound_by="bytes")


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
    from cropnerf_tpu_torch.ops.cuda.fused_mlp import (fused_mlp,
                                                       fused_mlp_bwd,
                                                       fused_mlp_plain)
    from cropnerf_tpu_torch.ops.cuda.fused_pe_field import (
        fused_pe_density, fused_pe_density_bwd, fused_pe_density_plain,
        fused_pe_nerf, fused_pe_nerf_bwd, fused_pe_nerf_plain)
    from cropnerf_tpu_torch.ops.posenc import nerf_encoding
    from cropnerf_tpu_torch.train.step import make_render_fn

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s for {', '.join(reports)} "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
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
        "fused_mlp semantic head": kmlp.smem_bytes(kmlp.pack_mlp(
            sem_wbs[0].shape[0], sem_wbs, dev)[2]),
        "fused_mlp colour head": kmlp.smem_bytes(kmlp.pack_mlp(
            col_wbs[0].shape[0], col_wbs, dev)[2])}
    log("[build] dynamic shared memory per block at the path's widths: "
        + ", ".join(f"{k} {v} B" for k, v in smem.items()))
    check(all(v > 0 for v in smem.values()), f"kernel layouts {smem}")

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
            ragged_rel_err=ragged, ms=device_ms(k1, 10, KERNEL_NS), call_ms=cuda_ms(k1, 10),
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
            ms=device_ms(kb, 5, KERNEL_NS), call_ms=cuda_ms(kb, 5),
            plain_ms=device_ms(pb, 3),
            flops=2.0 * n1 * bwd_macs,
            bytes=nbytes(xk, exk, *cotk, *wd) + nbytes(xk, exk, *wd))

        # K2 fused_pe_density: export trunk, 512 rays x 128 samples
        n2 = 512 * EXPORT_SIDE
        x2, _ = field_inputs(n2)
        k2 = lambda: fused_pe_density(x2, base, top, POS_FREQS)  # noqa: E731
        p2 = lambda: fused_pe_density_plain(x2, base, top, POS_FREQS)  # noqa: E731
        got, ref = k2(), p2()
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
            ms=device_ms(k2, 10, KERNEL_NS), call_ms=cuda_ms(k2, 10),
            plain_ms=device_ms(p2, 5),
            flops=2.0 * n2 * trunk_macs,
            bytes=nbytes(x2, *base, *top) + nbytes(got))

        # K3 fused_mlp: the export's semantic and colour heads, same chunk
        geo = torch.randn((n2, fcfg.geo_feat_dim), generator=g, device=dev)
        cin = torch.randn((n2, col_wbs[0].shape[0]), generator=g, device=dev)
        k3 = lambda: (fused_mlp(geo, sem_wbs), fused_mlp(cin, col_wbs))  # noqa: E731
        p3 = lambda: (fused_mlp_plain(geo, sem_wbs), fused_mlp_plain(cin, col_wbs))  # noqa: E731
        got, ref = k3(), p3()
        gr, cr = geo[:n2 - 3].contiguous(), cin[:n2 - 3].contiguous()
        ragged = max(rel_err(fused_mlp(gr, sem_wbs), fused_mlp_plain(gr, sem_wbs)),
                     rel_err(fused_mlp(cr, col_wbs), fused_mlp_plain(cr, col_wbs)))
        kernels["fused_mlp"] = dict(
            shape=(f"semantic head [{n2},{geo.shape[1]}]->64->1 and colour "
                   f"head [{n2},{cin.shape[1]}]->64->3 (one export chunk)"),
            source="cropnerf_tpu_torch/csrc/fused_mlp.cu",
            replaces="cropnerf_tpu/ops/pallas/fused_mlp.py:30",
            rel_err=max(rel_err(a, b) for a, b in zip(got, ref)),
            max_abs_err=max(abs_err(a, b) for a, b in zip(got, ref)),
            ragged_n=n2 - 3, ragged_rel_err=ragged,
            ms=device_ms(k3, 20, KERNEL_NS), call_ms=cuda_ms(k3, 20),
            plain_ms=device_ms(p3, 20),
            flops=2.0 * n2 * (mlp_macs([geo.shape[1], 64, 1])
                              + mlp_macs([cin.shape[1], 64, 3])),
            bytes=nbytes(geo, cin, *sem_wbs, *col_wbs, *got))

    for name, k in kernels.items():
        if name in ("fused_pe_density_bwd", "fused_mlp_bwd"):
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
            check(k["deterministic"], f"{name} differs between two runs")
            for share, l2 in k["rows"] + k["ragged_rows"]:
                check(share >= ROW_SHARE and l2 <= GRAD_TOL,
                      f"{name}: dx/dextras rows {share:.4f}, L2 {l2:.2e}")
    regs = ptxas_registers(reports["fused_pe_field_bwd"])
    bwd_smem = {
        "with the heads": kfield.bwd_smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, color, sem, de=de, device=dev)[2]),
        "trunk only": kfield.bwd_smem_bytes(kfield.pack_pe_field(
            3, POS_FREQS, base, top, device=dev)[2], False),
        "fused_mlp semantic head": kmlp.bwd_smem_bytes(kmlp.pack_mlp(
            sem_wbs[0].shape[0], sem_wbs, dev)[2]),
        "fused_mlp colour head": kmlp.bwd_smem_bytes(kmlp.pack_mlp(
            col_wbs[0].shape[0], col_wbs, dev)[2])}
    log(f"[build] fused_pe_field_bwd registers {regs}; backward dynamic "
        f"shared memory per block: "
        + ", ".join(f"{k} {v} B" for k, v in bwd_smem.items()))
    n_unc = RAYS * m.num_nerf_samples_per_ray        # one BayesRays batch
    kernels["fused_pe_density_bwd"] = density_bwd_entry(
        base, top, trunk_macs, n_unc, dev, card, reports["fused_pe_field_bwd"])
    kernels["fused_mlp_bwd"] = mlp_bwd_entry(
        {"semantic head": sem_wbs, "colour head": col_wbs}, n_unc, dev, card,
        reports["fused_mlp"])
    hash_k = hash_kernels(PRESETS["cropnerf"], dev, card,
                          reports["hash_encode"])

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
                    fused_pe_density_bwd, fused_mlp, fused_mlp_bwd)
    for fn in path_kernels:
        fn.launches = 0
    result = {}
    steps = {
        "forward": lambda: result.update(fwd=forward(params, rb, m)),
        "render": lambda: result.update(
            img=render(params, cams, 0, RENDER_HW, RENDER_HW)),
        "export": lambda: result.update(paths=export_and_write(
            params, m, aabb, out_dir, num_points_per_side=EXPORT_SIDE,
            render_rgb=True, **thresholds))}
    first_ms = {step: wall_ms(fn) for step, fn in steps.items()}
    launches = {fn.__name__: fn.launches for fn in path_kernels}
    log(f"[path] launches on the serving path: {launches}")
    check(all(v > 0 for k, v in launches.items() if not k.endswith("_bwd")),
          f"a kernel of the path never launched: {launches}")
    check(all(v == 0 for k, v in launches.items() if k.endswith("_bwd")),
          "serving recorded a graph and ran a backward")
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

    all_kernels = path_kernels + (hash_encode, hash_encode_bwd)
    hash_path, hash_forward = hash_serving(dev, card, rb, cams, aabb, out_dir,
                                           all_kernels)

    # ---- 5. the training path ---------------------------------------------
    from cropnerf_tpu_torch.data.databank import build_pixel_bank
    from cropnerf_tpu_torch.train.state import create_train_state
    from cropnerf_tpu_torch.train.step import (make_eval_batch_fn,
                                               make_train_step, train_loss)
    t0 = time.perf_counter()
    n_img, bh, bw = BANK
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (n_img, bh, bw, 3), dtype=np.uint8)
    masks = (rs.rand(n_img, bh, bw) > 0.9).astype(np.uint8)
    c2w_b = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n_img, 1, 1))
    c2w_b[:, :, 3] = rs.randn(n_img, 3) * 0.5
    full = lambda v: torch.full((n_img,), v, device=dev)  # noqa: E731
    bank = build_pixel_bank(images, masks, Cameras(
        c2w=torch.from_numpy(c2w_b).to(dev), fx=full(1000.0), fy=full(1000.0),
        cx=full(bw / 2.0), cy=full(bh / 2.0), width=full(bw).long(),
        height=full(bh).long()), device=dev)
    del images, masks
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
    hash_train, hash_step = hash_training(dev, card, bank, all_kernels)
    steps["cropnerf forward"] = hash_forward
    steps["cropnerf train step"] = hash_step

    # ---- 5b. the BayesRays pass and the uncertainty-filtered paths -------
    unc, unc_steps = uncertainty_phase(dev, card, bank, cams, all_kernels)
    steps.update(unc_steps)

    # ---- 6. where the time goes: one traced call of each path step ------
    breakdown = {}
    for step, fn in steps.items():
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

    # ---- 7. report ---------------------------------------------------------
    unc_mxu = unc["cropnerf-mxu"]["launches"]
    by_path = {name: {"serving": launches[name],
                      "train": train_launches[name],
                      "uncertainty": unc_mxu[name]} for name in kernels}
    # each kernel's main path: K1 the training step, K2 and K3 forward the
    # export, their backwards the BayesRays pass
    main_launches = {name: (train_launches[name]
                            if name.startswith("fused_pe_nerf") else
                            unc_mxu[name] if name.endswith("_bwd") else
                            launches[name]) for name in kernels}
    line = {"kernels": [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=main_launches[name],
        launches_by_path=by_path[name], max_abs_err=k["max_abs_err"],
        rel_err=k["rel_err"], ms=k["ms"], call_ms=k["call_ms"],
        plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], card=card) for name, k in kernels.items()] + [dict(
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
        by_shape=k["by_shape"]) for name, k in hash_k.items()],
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
        "trace": breakdown,
        "unported_bounds": unported_bounds(PRESETS)}
    for name, b in line["unported_bounds"].items():
        log(f"[bounds] {name} (not ported, not measured): {b['shape']}: "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    print(json.dumps(line), flush=True)
    shutil.rmtree(out_dir)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
