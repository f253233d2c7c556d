"""How far one training step of the PyTorch port moves from the JAX
package's in float32, over several pixel draws, and how far the port moves
from itself when its products are summed in float64.

Both differences come from summation order: a relu unit whose
pre-activation lies within rounding of zero takes either side.  The tests
in tests/test_torch_train.py (``--preset cropnerf-mxu``),
tests/test_torch_hash_model.py (``--preset cropnerf``, the hash-grid
model) and tests/test_torch_propfused.py (``--preset cropnerf-mxu-q``,
with both proposal nets 128 wide on the fused kernel) set their bounds
from these numbers.  Runs on the CPU (JAX and
PyTorch side by side, as the tests do):

    JAX_PLATFORMS=cpu python tools/torch_train_parity_draws.py --draws 10 \
        --preset cropnerf
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
os.environ["CROPNERF_FP32_MATMUL"] = "1"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cropnerf_tpu_torch.ops.cuda.fused_pe_field as pe_field  # noqa: E402
import cropnerf_tpu_torch.ops.mlp as mlp  # noqa: E402
import test_torch_train as T  # noqa: E402


def mm_f64_sums(a, w, compute_dtype):
    return (a.to(compute_dtype).double() @ w.to(compute_dtype).double()).float()


def case(preset: str):
    """(JAX config, port config, params factory, relu-leaf predicate, step)
    of the named test's training step."""
    if preset == "cropnerf-mxu":
        jcfg, tcfg = T._cfgs()
        return (jcfg, tcfg, lambda: T.jax_and_torch_params(
            jcfg.model, num_images=T.N_IMG), T._kinked, T.STEP)
    if preset == "cropnerf-mxu-q":
        from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
        from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
        from test_torch_propfused import propfused
        jcfg, tcfg = (propfused(p, preset, train_num_rays_per_batch=T.RAYS)
                      for p in (JAX_PRESETS, TORCH_PRESETS))
        return (jcfg, tcfg, lambda: T.jax_and_torch_params(
            jcfg.model, num_images=T.N_IMG), T._kinked, T.STEP)
    import dataclasses

    import test_torch_hash_model as M
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, proposal_no_grad_schedule=False))
        for c in M._cfgs(train_num_rays_per_batch=T.RAYS))
    return jcfg, tcfg, M._params, hash_relu_leaf, M.UPDATE_STEP


def hash_relu_leaf(leaf: str) -> bool:
    """Hash-grid model leaves behind a relu unit: the grids, the
    appearance table, camera_opt and every layer but the last of each
    MLP."""
    parts = leaf.split(".")
    if parts[-1] in ("grid", "appearance", "camera_opt"):
        return True
    n_layers = {"mlp_base": 2, "mlp_semantic": 2, "mlp_color": 3,
                "mlp": 2, "semantic_head": 1}[parts[-3]]
    return int(parts[-1]) < n_layers - 1


def port_grads(tcfg, tb, idx, mm, params_fn, step):
    """The port's gradient leaves, and the rays' origins' and directions'
    gradients under "rays.origins" and "rays.directions"."""
    mlp.mm_f32acc = pe_field.mm_f32acc = mm
    _, tp = params_fn()
    rays, bank_rays = {}, T.tstep._bank_rays

    def spy(*args):
        out = bank_rays(*args)
        rays["rb"] = out[2]
        out[2].origins.requires_grad_(True)
        out[2].directions.requires_grad_(True)
        return out

    T.tstep._bank_rays = spy
    try:
        loss, _ = T.tstep.train_loss(tp, tb, torch.from_numpy(idx), step,
                                     tcfg, compute_dtype=torch.float32)
        loss.backward()
    finally:
        T.tstep._bank_rays = bank_rays
    grads = {k: p.grad.numpy().copy() for k, p in tp.named_parameters()}
    grads["rays.origins"] = rays["rb"].origins.grad.numpy().copy()
    grads["rays.directions"] = rays["rb"].directions.grad.numpy().copy()
    return grads


def rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=10)
    ap.add_argument("--preset", choices=("cropnerf-mxu", "cropnerf-mxu-q",
                                         "cropnerf"),
                    default="cropnerf-mxu")
    args = ap.parse_args()
    import jax
    jcfg, tcfg, params_fn, kinked, step = case(args.preset)
    jb, tb = T._banks()
    plain_mm = mlp.mm_f32acc
    for seed in range(args.draws):
        idx = np.random.default_rng(seed).integers(0, jb.num_pixels, (T.RAYS,))
        jidx = jnp.asarray(idx, jnp.int32)
        params, _ = params_fn()
        (_, _), (grads, g_o, g_d) = jax.jit(jax.value_and_grad(
            T._jax_loss_fn(jcfg, jb, jidx, step), argnums=(0, 1, 2),
            has_aux=True))(params, *T._jax_rays(jb, jidx))
        ref = T._named(grads)
        ref["rays.origins"], ref["rays.directions"] = (np.asarray(g_o),
                                                       np.asarray(g_d))
        f32 = port_grads(tcfg, tb, idx, plain_mm, params_fn, step)
        f64 = port_grads(tcfg, tb, idx, mm_f64_sums, params_fn, step)
        for label, keys in (("relu", [k for k in ref if kinked(k)]),
                            ("other", [k for k in ref if not kinked(k)
                                       and k != "camera_opt"
                                       and not k.startswith("rays.")])):
            jx = max(keys, key=lambda k: rel(f32[k], ref[k]))
            me = max(keys, key=lambda k: rel(f32[k], f64[k]))
            l2 = max(float(np.linalg.norm(f32[k] - ref[k])
                           / max(np.linalg.norm(ref[k]), 1e-12)) for k in keys)
            print(f"draw {seed} {label}: port vs JAX {rel(f32[jx], ref[jx]):.2e}"
                  f" ({jx}), largest relative L2 {l2:.2e}; port vs float64 "
                  f"sums {rel(f32[me], f64[me]):.2e} ({me})")
        print(f"draw {seed} rays: relative L2 port vs JAX " + ", ".join(
            f"{k} {np.linalg.norm(f32[k] - ref[k]) / np.linalg.norm(ref[k]):.2e}"
            for k in ("rays.origins", "rays.directions")))
    mlp.mm_f32acc = pe_field.mm_f32acc = plain_mm


if __name__ == "__main__":
    main()
