"""One rank of the port's two-rank CPU checks (tests/test_torch_ddp.py).

Run by the test in one process per rank, with the launcher's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and CROPNERF_PLATFORM=cpu:

    python tests/torch_ddp_worker.py WORKDIR

It reads WORKDIR/inputs.npz and WORKDIR/mxu_params.pt (written by the
test), joins the gloo group, runs each case and saves what it found to
WORKDIR/rank{r}.pt; last, it runs ``train --multichip --shard-bank on``
through the CLI's ``main`` on the dataset WORKDIR/ds into WORKDIR/run, in
the group it joined, and ``export --multichip`` of a copy of that run
(WORKDIR/run_served: a serving command rewrites the run's metadata, as
the JAX package's does) into WORKDIR/export_cli.  It imports the port only, never JAX, so that it
starts quickly.
"""
from __future__ import annotations

import dataclasses
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# TensorBoard's own switch to its TF-free stub (what its no_tensorflow
# build sets): the trainer's event writer works the same, and rank 0 does
# not spend seconds importing TensorFlow
sys.modules.setdefault("tensorboard.compat.notf",
                       types.ModuleType("tensorboard.compat.notf"))

from cropnerf_tpu_torch import cli  # noqa: E402
from cropnerf_tpu_torch.core.cameras import Cameras  # noqa: E402
from cropnerf_tpu_torch.data import databank  # noqa: E402
from cropnerf_tpu_torch.export.volume import export_and_write  # noqa: E402
from cropnerf_tpu_torch.models.config import PRESETS  # noqa: E402
from cropnerf_tpu_torch.parallel.dist import (  # noqa: E402
    barrier, initialize_multihost, shutdown)
from cropnerf_tpu_torch.projection.project import run_projections  # noqa: E402
from cropnerf_tpu_torch.train import step as tstep  # noqa: E402
from cropnerf_tpu_torch.train.debug import (  # noqa: E402
    assert_sharded_step_matches_replay)
from cropnerf_tpu_torch.train.state import create_train_state  # noqa: E402

F32 = torch.float32
RAYS = 32            # the training batch of every case, 16 a rank
JAX_STEP = 300       # the step of the case held against JAX
REPLICATED_STEPS = 3
EXPORT_SIDE = 12
DISPATCH = 128       # projection rays per dispatch: several dispatches
TRAIN_STEPS = 3      # the CLI's train


def reduced_mxu(**changes):
    """tests/torch_parity.py's reduced_mxu on the port's presets."""
    cfg = PRESETS["cropnerf-mxu"]
    m = dataclasses.replace(cfg.model, num_nerf_samples_per_ray=8,
                            num_proposal_samples_per_ray=(32, 16))
    return dataclasses.replace(cfg, model=m, **changes)


def tiny(**changes):
    return dataclasses.replace(PRESETS["cropnerf-tiny"], **changes)


def cameras(inp, prefix="cam_") -> Cameras:
    arrays = {k[len(prefix):]: torch.from_numpy(inp[k]) for k in inp.files
              if k.startswith(prefix)}
    return Cameras(**arrays)


def sharded_banks(inp, mesh):
    """(this rank's shard, the global padded bank) of the inputs."""
    images, masks, cams = databank.pad_images_for_sharding(
        inp["images"], inp["masks"], cameras(inp), mesh.size)
    lo, hi = databank.process_image_range(images.shape[0], mesh)
    shard = databank.build_sharded_pixel_bank(images[lo:hi], masks[lo:hi],
                                              cams, mesh)
    return shard, databank.build_pixel_bank(images, masks, cams, "cpu")


def state_of(cfg, num_images, seed=0, params=None):
    state = create_train_state(cfg, num_images,
                               torch.Generator().manual_seed(seed), "cpu")
    if params is not None:
        state.params.load_state_dict(params)
    return state


def main() -> None:
    work = Path(sys.argv[1])
    inp = np.load(work / "inputs.npz")
    torch.set_num_threads(2)
    mesh = initialize_multihost(platform="cpu", timeout_s=120)
    r = mesh.rank
    res = {}

    # the sharded bank's rows
    shard, bank_g = sharded_banks(inp, mesh)
    res["bank_rgb"] = shard.rgb.numpy()
    res["bank_mask"] = shard.mask.numpy()
    res["image_offset"] = shard.image_offset
    res["num_images"] = shard.num_images

    # the sharded step on the indices JAX derives, no jitter (vs JAX)
    cfg = reduced_mxu(train_num_rays_per_batch=RAYS)
    state = state_of(cfg, bank_g.num_images,
                     params=torch.load(work / "mxu_params.pt"))
    state.step = JAX_STEP
    step = tstep.make_sharded_train_step(cfg, mesh, return_grads=True,
                                         compute_dtype=F32)
    _, m = step(state, shard, None,
                local_idx=torch.from_numpy(inp["jax_idx"][r]))
    res["jax_case"] = {k: (v if k == "grads" else float(v))
                       for k, v in m.items()}

    # the sharded step against the replay oracle (with jitter)
    state = state_of(cfg, bank_g.num_images, seed=1)
    res["replay_max_dev"] = assert_sharded_step_matches_replay(
        state, shard, bank_g, torch.Generator().manual_seed(7), cfg, mesh,
        atol_camera_opt=1e-3, compute_dtype=F32)

    # the replicated bank: the two-rank step against the one-process step
    tcfg = tiny(train_num_rays_per_batch=RAYS)
    bank = databank.build_pixel_bank(inp["images"], inp["masks"],
                                     cameras(inp), "cpu")
    one = state_of(tcfg, bank.num_images, seed=2)
    _, m1 = tstep.make_train_step(tcfg, compute_dtype=F32,
                                  return_grads=True)(
        one, bank, torch.Generator().manual_seed(11))
    dp = state_of(tcfg, bank.num_images, seed=2)
    step = tstep.make_train_step(tcfg, compute_dtype=F32, mesh=mesh,
                                 return_grads=True)
    gen = torch.Generator().manual_seed(11)
    _, m2 = step(dp, bank, gen)
    res["replicated"] = {
        "one": {k: (v if k == "grads" else float(v)) for k, v in m1.items()},
        "ranks": {k: (v if k == "grads" else float(v))
                  for k, v in m2.items()}}
    for _ in range(REPLICATED_STEPS - 1):
        step(dp, bank, gen)
    res["replicated_params"] = {k: v.detach().clone() for k, v in
                                dp.params.state_dict().items()}

    # export and project over the ranks, and on rank 0 alone
    params = state_of(tcfg, bank.num_images, seed=3).params
    kw = dict(dataparser_scale=2.0, num_points_per_side=EXPORT_SIDE,
              rays_per_batch=64, semantic_threshold=-100.0,
              density_threshold=0.0, colormap_threshold=0.1,
              compute_dtype=F32)
    aabb = inp["aabb"]
    export_and_write(params, tcfg.model, aabb, work / "export_ranks",
                     mesh=mesh, **kw)
    info = np.array([{"aabb": inp["boxes"]}], dtype=object)
    cams = cameras(inp, "ring_")
    hw = int(inp["ring_height"][0])
    report = run_projections(params, tcfg.model, cams, hw, hw, info,
                             work / "project_ranks", compute_dtype=F32,
                             mesh=mesh, rays_per_dispatch=DISPATCH)
    res["project_dispatches"] = report.plan["dispatches"]
    if mesh.is_main:
        export_and_write(params, tcfg.model, aabb, work / "export_one", **kw)
        run_projections(params, tcfg.model, cams, hw, hw, info,
                        work / "project_one", compute_dtype=F32,
                        rays_per_dispatch=DISPATCH)
    torch.save(res, work / f"rank{r}.pt")
    barrier("cases done", mesh)

    # the CLI under the launcher's environment joins this group
    cli.main(["train", "--method", "cropnerf-tiny", "--data",
              str(work / "ds"), "--output", str(work / "run"),
              "--max-steps", str(TRAIN_STEPS), "--train-split-fraction",
              "0.8", "--multichip", "--shard-bank", "on"])
    if mesh.is_main:
        shutil.copytree(work / "run", work / "run_served")
    barrier("run copied", mesh)
    cli.main(["export", "--run-dir", str(work / "run_served"), "--multichip",
              "--output-dir", str(work / "export_cli"),
              *map(str, inp["export_args"])])
    shutdown()


if __name__ == "__main__":
    main()
