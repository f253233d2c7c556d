#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cropnerf_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

1. builds the CUDA kernels from cropnerf_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, started together) and prints each kernel's
   registers, shared memory and spills;
2. prints the card (torch and nvidia-smi: name, power limit);
3. holds every kernel against its plain PyTorch version at the shapes the
   cropnerf-mxu serving path gives it and at a ragged N, and times both;
4. drives that path with random weights (full cropnerf-mxu widths, from a
   seeded torch.Generator): forward at 4096 rays, a 256x256 render (two
   32,768-ray chunks) and a 128^3 volume export with colours, with the
   launch counts zeroed just before and read just after; then runs the
   same calls with the field on the plain path and compares;
5. traces one forward, render and export with torch.profiler and prints
   the device time of the busiest operations and the device's busy share;
6. prints one JSON line of kernel numbers, the nvidia-smi card line, and
   the status line last.

Any failed phase raises and the script exits non-zero.  It needs a CUDA
device and the repository beside it; without either it fails before it
prints a result.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOL = 1e-2               # max |kernel - plain| / max |plain|, bf16 compute
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth
RAYS = 4096              # the forward's ray batch (the JAX entry() batch)
RENDER_HW = 256          # full-image render, two 32,768-ray chunks
EXPORT_SIDE = 128        # volume export: 128^3 samples over the AABB
KERNEL_NS = "cropnerf::"  # the port's kernels in profiler rows
REPEATS = 5              # timed runs of each path step after its first call


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


def mlp_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    from cropnerf_tpu_torch.models.field import field_density, field_semantics
    from cropnerf_tpu_torch.models.model import forward, model_init
    from cropnerf_tpu_torch.models.vanilla import (DIR_FREQS, POS_FREQS,
                                                   fused_field_weights)
    from cropnerf_tpu_torch.ops.cuda import build
    from cropnerf_tpu_torch.ops.cuda import fused_mlp as kmlp
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as kfield
    from cropnerf_tpu_torch.ops.cuda.fused_mlp import fused_mlp, fused_mlp_plain
    from cropnerf_tpu_torch.ops.cuda.fused_pe_field import (
        fused_pe_density, fused_pe_density_plain, fused_pe_nerf,
        fused_pe_nerf_plain)
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
        k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
        log(f"[kernel] {name}: {k['shape']}; err {k['rel_err']:.2e} "
            f"(ragged N={k['ragged_n']}: {k['ragged_rel_err']:.2e}), "
            f"tol {TOL}; kernel {k['ms']:.4f} ms (wrapper call with weight "
            f"packing {k['call_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}); {card}")
        check(k["rel_err"] <= TOL and k["ragged_rel_err"] <= TOL,
              f"{name} disagrees with its plain version")

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
    # The reference thresholds (density 70, logit 3, sigmoid 0.9) keep no
    # sample of a field with random weights; take them from the field's own
    # quantiles over the box, so that every cloud holds points.
    with torch.no_grad():
        pts = torch.rand((65536, 3), generator=g, device=dev) * 2 - 1
        dens, geo = field_density(params.field, pts, fcfg)
        logit = field_semantics(params.field, geo, fcfg)[:, 0]
    thresholds = dict(density_threshold=dens.quantile(0.75).item(),
                      semantic_threshold=logit.quantile(0.5).item(),
                      colormap_threshold=torch.sigmoid(
                          logit.quantile(0.25)).item())
    log(f"[path] export thresholds {thresholds}")
    render = make_render_fn(cfg)
    plain_m = dataclasses.replace(
        m, field=dataclasses.replace(m.field, mlp_impl="xla"))
    render_plain = make_render_fn(dataclasses.replace(cfg, model=plain_m))
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))

    for fn in (fused_pe_nerf, fused_pe_density, fused_mlp):
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
    launches = {fn.__name__: fn.launches
                for fn in (fused_pe_nerf, fused_pe_density, fused_mlp)}
    log(f"[path] launches on the serving path: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
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

    # ---- 5. where the time goes: one traced forward, render and export ---
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

    # ---- 6. report ---------------------------------------------------------
    line = {"kernels": [dict(
        name=name, route="cuda", source=k["source"], replaces=k["replaces"],
        launches=launches[name], max_abs_err=k["max_abs_err"],
        rel_err=k["rel_err"], ms=k["ms"], call_ms=k["call_ms"],
        plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], card=card) for name, k in kernels.items()],
        "path": {"card": card, "repeats": REPEATS, "median_ms": med_ms,
                 "runs_ms": runs_ms, "first_ms": first_ms,
                 "forward_rays_per_s": RAYS / med_ms["forward"] * 1e3,
                 "render_rays_per_s": n_px / med_ms["render"] * 1e3,
                 "export_points": counts},
        "trace": breakdown}
    print(json.dumps(line), flush=True)
    shutil.rmtree(out_dir)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
