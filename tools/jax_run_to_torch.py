"""Convert a JAX run directory's latest orbax checkpoint into the PyTorch
port's checkpoint, so that ``cropnerf_tpu_torch`` resumes, exports and
renders the run.

Reads ``<run>/run_config.json`` (the model and the image count) and the
newest ``<run>/checkpoints/step-*`` orbax directory that ``cropnerf_tpu``'s
trainer wrote.  Writes ``<run>/checkpoints/step-{step:09d}.pt`` beside it:
the parameters through ``cropnerf_tpu_torch.convert.params_from_jax``, the
optimizer state and the step.  Each optimizer group's Adam or RAdam state
(optax ``ScaleByAdamState``: ``mu``, ``nu`` and ``count``) becomes torch's
``exp_avg``, ``exp_avg_sq`` and ``step`` for every parameter of that
group.  Where a group's moments cannot be found (a params-only checkpoint,
another optax chain), the tool says so and writes the parameters and the
step only; the port's trainer then starts its optimizer afresh.

This tool imports JAX, orbax and both packages; the port itself imports
neither.  Run it from the root of the repository:

    python tools/jax_run_to_torch.py --run-dir RUN
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import jax
import numpy as np
import optax
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from cropnerf_tpu.models.config import \
    train_config_from_dict as jax_train_config  # noqa: E402
from cropnerf_tpu.train.state import create_train_state  # noqa: E402
from cropnerf_tpu_torch.convert import params_from_jax  # noqa: E402
from cropnerf_tpu_torch.models.config import \
    train_config_from_dict as torch_train_config  # noqa: E402
from cropnerf_tpu_torch.train.optim import GROUPS, make_optimizer  # noqa: E402


def latest_orbax_checkpoint(run_dir: Path) -> Path:
    ckpts = sorted(p for p in (Path(run_dir) / "checkpoints").glob("step-*")
                   if p.is_dir())
    if not ckpts:
        raise FileNotFoundError(f"no orbax checkpoint under {run_dir}/checkpoints")
    return ckpts[-1]


def restore_jax_checkpoint(run_dir: Path, path: Path) -> dict:
    """{"params", "opt_state" (None when absent), "step"} as host numpy,
    restored against the run's own train state as the JAX trainer does."""
    import orbax.checkpoint as ocp
    meta = json.loads((Path(run_dir) / "run_config.json").read_text())
    cfg = jax_train_config(meta["config"])
    state = create_train_state(jax.random.PRNGKey(cfg.seed), cfg,
                               int(meta["num_train_images"]))
    target = {"params": jax.device_get(state.params),
              "opt_state": jax.device_get(state.opt_state),
              "step": jax.device_get(state.step)}
    ckptr = ocp.StandardCheckpointer()
    try:
        restored = ckptr.restore(Path(path).absolute(), target)
    except Exception as e:  # noqa: BLE001 - orbax raises several kinds
        print(f"{path.name}: no optimizer state restored ({type(e).__name__}: "
              f"{e}); converting params and step only", flush=True)
        restored = ckptr.restore(Path(path).absolute(),
                                 {"params": target["params"],
                                  "step": target["step"]})
        restored["opt_state"] = None
    return jax.tree_util.tree_map(np.asarray, restored)


def _is_adam_state(node) -> bool:
    return isinstance(node, optax.ScaleByAdamState)


def group_moments(opt_state) -> Dict[str, optax.ScaleByAdamState]:
    """Group name → its ScaleByAdamState, for the groups where one is found
    in ``opt_state`` (optax.multi_transform's PartitionState)."""
    out = {}
    inner = getattr(opt_state, "inner_states", None) or {}
    for g in GROUPS:
        if g not in inner:
            continue
        found = [n for n in jax.tree_util.tree_leaves(
            inner[g], is_leaf=_is_adam_state) if _is_adam_state(n)]
        if len(found) == 1:
            out[g] = found[0]
    return out


def _unmasked(tree) -> dict:
    """A group's moment tree without the other groups' masked entries."""
    return {k: v for k, v in tree.items()
            if not isinstance(v, optax.MaskedNode)}


def convert(restored: dict, cfg) -> dict:
    """The port's checkpoint dict from a restored JAX checkpoint: "params"
    and "step", and "optimizers" when every group's moments map."""
    params = params_from_jax(restored["params"], device="cpu")
    step = int(restored["step"])
    ckpt = {"params": params.state_dict(), "step": step}
    optimizer = make_optimizer(params, cfg)
    used = {g["name"] for g in optimizer.param_groups}
    moments = (group_moments(restored["opt_state"])
               if restored["opt_state"] is not None else {})
    missing = sorted(used - set(moments))
    if missing:
        print(f"no Adam/RAdam moments for group(s) {missing}: writing params "
              f"and step only", flush=True)
        return ckpt
    mu, nu = {}, {}
    for g in used:
        mu.update(_unmasked(moments[g].mu))
        nu.update(_unmasked(moments[g].nu))
    # the moments have the params' tree, so the converter lays them out as
    # parameters with the same names
    mu_t = dict(params_from_jax(mu, device="cpu").named_parameters())
    nu_t = dict(params_from_jax(nu, device="cpu").named_parameters())
    names = {id(p): n for n, p in params.named_parameters()}
    for opt in optimizer.optimizers:
        for group in opt.param_groups:
            count = float(moments[group["name"]].count)
            for p in group["params"]:
                n = names[id(p)]
                opt.state[p] = {"step": torch.tensor(count),
                                "exp_avg": mu_t[n].detach().clone(),
                                "exp_avg_sq": nu_t[n].detach().clone()}
    ckpt["optimizers"] = optimizer.state_dict()
    return ckpt


def convert_run(run_dir: Path, checkpoint: Optional[Path] = None) -> Path:
    """Convert ``checkpoint`` (default: the run's newest orbax checkpoint)
    and write the port's ``step-*.pt`` beside it."""
    run_dir = Path(run_dir)
    path = Path(checkpoint) if checkpoint else latest_orbax_checkpoint(run_dir)
    restored = restore_jax_checkpoint(run_dir, path)
    meta = json.loads((run_dir / "run_config.json").read_text())
    ckpt = convert(restored, torch_train_config(meta["config"]))
    out = run_dir / "checkpoints" / f"step-{ckpt['step']:09d}.pt"
    torch.save(ckpt, out)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run-dir", type=Path, required=True)
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="an orbax step-* directory (default: the newest)")
    args = parser.parse_args()
    print(convert_run(args.run_dir, args.checkpoint))


if __name__ == "__main__":
    main()
