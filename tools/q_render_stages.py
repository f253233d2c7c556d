"""Where the PyTorch port's float32 render of ``cropnerf-mxu-q`` leaves the
JAX package's, stage by stage, on one seeded ray batch.

Renders the image of ``tests/test_torch_propfused_wide.py``'s
``test_q_render_matches_jax`` (the preset at full widths with 32, 16 and 8
samples a ray, both PE proposal nets on the fused kernel, or with
``--proposal plain`` on plain matmuls; an 8x8 view, one chunk) in both
packages in the float32 arm, JAX eagerly (``jax.disable_jit``), and
records each stage's inputs and outputs: the initial samples, each
proposal net's density, each level's weights, each PDF resampling's bins,
the field's outputs, the final weights, the semantics and the median
depth.  For each stage it prints:

- chained: max |port - JAX| of the outputs over max |JAX|, each package on
  its own inputs;
- isolated: the same with the port's stage run on JAX's recorded inputs
  (what the stage itself adds);
- f64: the port's stage in float64 on JAX's inputs against JAX's output
  and against the port's float32 output (which package rounds further
  from the exact value); the nets' and the field's float64 runs keep their
  products in float64.

The first stage whose isolated difference stands above float32 rounding
carries the gap.  It also prints how concentrated the final weights are
(a ray's largest weight over its sum, the mean over rays).  Runs on the
CPU in about a minute:

    JAX_PLATFORMS=cpu python tools/q_render_stages.py [--proposal plain]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ["CROPNERF_FP32_MATMUL"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cropnerf_tpu.models.model as jmodel  # noqa: E402
import cropnerf_tpu.ops.pdf as jpdf  # noqa: E402
import cropnerf_tpu.ops.render as jrender  # noqa: E402
import cropnerf_tpu_torch.models.model as tmodel  # noqa: E402
import cropnerf_tpu_torch.ops.mlp as tmlp  # noqa: E402
import cropnerf_tpu_torch.ops.pdf as tpdf  # noqa: E402
import cropnerf_tpu_torch.ops.render as trender  # noqa: E402

STAGES = ((jpdf, tpdf, "sample_spaced"), (jpdf, tpdf, "sample_pdf"),
          (jmodel, tmodel, "proposal_density"), (jmodel, tmodel, "field_all"),
          (jrender, trender, "render_weights"),
          (jrender, trender, "render_semantics"),
          (jrender, trender, "render_depth_median"))


def record(log: list, module, name: str) -> None:
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((name, args, kwargs, out))
        return out

    setattr(module, name, wrapped)


def arrays(out) -> list:
    """The float arrays of a stage's output, as float64 numpy."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in arrays(o)]
    if hasattr(out, "spacing_starts"):               # RaySamples: its bins
        return arrays((out.spacing_starts, out.spacing_ends, out.positions))
    if isinstance(out, torch.Tensor):
        return [out.detach().double().numpy()]
    return [np.asarray(out, np.float64)]


def rel(got: list, ref: list) -> float:
    return max(float(np.abs(g.reshape(r.shape) - r).max()
                     / max(np.abs(r).max(), 1e-30)) for g, r in zip(got, ref))


def t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def f64_rb(rb):
    return dataclasses.replace(rb, **{
        f.name: getattr(rb, f.name).double()
        for f in dataclasses.fields(rb)
        if isinstance(getattr(rb, f.name), torch.Tensor)
        and getattr(rb, f.name).is_floating_point()})


def mm_f64(a, w, compute_dtype):
    """The nets' products in float64 (operands not rounded)."""
    return a.double() @ w.double()


def replay(name, targs, jargs, tcfg, tp, occurrence, dtype):
    """The port's stage ``name`` on JAX's recorded inputs ``jargs`` (the
    port's own recorded call ``targs`` for what JAX's signature lacks)."""
    m = tcfg.model
    if name == "render_weights":
        return trender.render_weights(t(jargs[0], dtype), t(jargs[1], dtype))
    if name == "render_semantics":
        return trender.render_semantics(t(jargs[0], dtype), t(jargs[1], dtype))
    if name == "render_depth_median":
        return trender.render_depth_median(t(jargs[0], dtype),
                                           t(jargs[1], dtype))
    if name == "sample_pdf":
        rb = targs[0] if dtype == torch.float32 else f64_rb(targs[0])
        return tpdf.sample_pdf(rb, t(jargs[2], dtype), t(jargs[3], dtype),
                               *targs[3:])
    if name == "proposal_density":
        pcfg = m.proposal_fields[occurrence]
        if dtype == torch.float64:                  # its plain matmuls
            pcfg = dataclasses.replace(pcfg, mlp_impl="xla")
        return tmodel.proposal_density(tp.proposal(occurrence),
                                       t(jargs[1], dtype), pcfg,
                                       compute_dtype=dtype)
    if name == "field_all":
        fcfg = m.field
        if dtype == torch.float64:                  # its plain matmuls
            fcfg = dataclasses.replace(fcfg, mlp_impl="xla")
        return tmodel.field_all(tp.field, t(jargs[1], dtype),
                                t(jargs[2], dtype), t(jargs[3], torch.int64),
                                fcfg, False, dtype,
                                m.pass_semantic_gradients)
    return None                                         # sample_spaced


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="cropnerf-mxu-q")
    parser.add_argument("--proposal", choices=("fused", "plain"),
                        default="fused")
    args = parser.parse_args()
    from cropnerf_tpu.core.cameras import Cameras as JaxCameras
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu.train.step import make_render_fn as jax_render
    from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from cropnerf_tpu_torch.train.step import make_render_fn
    from test_torch_propfused import propfused
    from test_torch_render_export import H, W, _camera_arrays
    from torch_parity import jax_and_torch_params, reduced_mxu

    def cfg(presets):
        if args.proposal == "fused":
            return propfused(presets, args.preset,
                             eval_num_rays_per_chunk=H * W)
        return dataclasses.replace(reduced_mxu(presets, args.preset),
                                   eval_num_rays_per_chunk=H * W)

    jcfg, tcfg = cfg(JAX_PRESETS), cfg(TORCH_PRESETS)
    params, tp = jax_and_torch_params(jcfg.model, num_images=1)
    cams = _camera_arrays()
    jlog, tlog = [], []
    for jm, tm, name in STAGES:
        record(jlog, jm, name)
        record(tlog, tm, name)
    with jax.disable_jit():
        ref = jax_render(jcfg)(params, JaxCameras(
            **{k: jnp.asarray(v) for k, v in cams.items()}), 0, H, W)
    got = make_render_fn(tcfg, compute_dtype=torch.float32)(
        tp, TorchCameras(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        0, H, W)
    tcalls = {}
    for name, targs, _, tout in tlog:
        tcalls.setdefault(name, []).append((targs, tout))
    assert sorted(e[0] for e in jlog) == sorted(e[0] for e in tlog)

    rows, seen = [], {}
    for name, jargs, _, jout in jlog:            # JAX's order
        k = seen[name] = seen.get(name, -1) + 1
        targs, tout = tcalls[name][k]
        jargs = [a for a in jargs if not (hasattr(a, "dtype")
                                          and a.dtype == jnp.uint32)]
        row = {"stage": f"{name} {k}", "chained": rel(arrays(tout),
                                                      arrays(jout))}
        iso = replay(name, targs, jargs, tcfg, tp, k, torch.float32)
        if iso is not None:
            row["isolated"] = rel(arrays(iso), arrays(jout))
            orig = tmlp.mm_f32acc
            tmodel_mm = [(mod, "mm_f32acc") for mod in list(sys.modules.values())
                         if getattr(mod, "mm_f32acc", None) is orig]
            for mod, attr in tmodel_mm:
                setattr(mod, attr, mm_f64)
            try:
                exact = arrays(replay(name, targs, jargs, tcfg, tp, k,
                                      torch.float64))
            finally:
                for mod, attr in tmodel_mm:
                    setattr(mod, attr, orig)
            row["f64_vs_jax"] = rel(arrays(jout), exact)
            row["f64_vs_port"] = rel(arrays(iso), exact)
        rows.append(row)
    for k in ("semantics", "rgb", "accumulation", "depth"):
        rows.append({"stage": f"output {k}", "chained": rel(
            [got[k].double().numpy()], [np.asarray(ref[k], np.float64)])})
    # how concentrated the final weights are: a ray's largest weight over
    # its sum, the mean over rays (JAX's)
    final = arrays([e[3] for e in jlog if e[0] == "render_weights"][-1])[0]
    peak = float(np.mean(final.max(-1) / np.maximum(final.sum(-1), 1e-30)))
    width = max(len(r["stage"]) for r in rows)
    print(f"{'stage':<{width}}  chained   isolated  f64-JAX   f64-port")
    for r in rows:
        print(f"{r['stage']:<{width}}  " + "  ".join(
            f"{r[c]:.2e}" if c in r else "   -    " for c in
            ("chained", "isolated", "f64_vs_jax", "f64_vs_port")))
    print(f"final weights: a ray's largest over its sum, mean {peak:.4f}")
    print(json.dumps({"preset": args.preset, "proposal": args.proposal,
                      "weight_peak": peak, "stages": rows}))


if __name__ == "__main__":
    main()
