"""The port's data parallelism (cropnerf_tpu_torch/parallel, the sharded
bank, the data-parallel steps, the replay oracle, export and project over
ranks, and the CLI's --multichip and --shard-bank) on the CPU, against the
JAX package where it has a counterpart.

Two gloo ranks run as two processes (tests/torch_ddp_worker.py, with a
launcher's environment and a free localhost port), each under a timeout
of its own that kills both and fails the test.  One run of the worker
serves most tests: the JAX side of each comparison runs here.

Tolerances: the padding helpers and the bank's rows exactly; the sharded
step on JAX's per-device indices (float32 arm, no jitter) against the
average of JAX's per-device gradients with tests/test_torch_train.py's
bounds (the trunk's leaves under its relu-kink bound, camera_opt against
the rays' gradients); the replay oracle at the JAX oracle's float32
tolerances (atol 3e-5, rtol 1e-2, camera_opt 1e-3); the replicated bank's
two-rank step against the one-process step to float32 reassociation
(1e-5 of each leaf's largest value); export and project byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.core.cameras import Cameras as JaxCameras
from cropnerf_tpu.data import databank as jbank
from cropnerf_tpu.data.dataparser import DataparserConfig as JaxDataConfig
from cropnerf_tpu.data.dataparser import parse_transforms as jax_parse
from cropnerf_tpu.data.dataset import SEMANTIC_THRESHOLD
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.models.model import model_init as jax_model_init
from cropnerf_tpu.train.trainer import Trainer as JaxTrainer
from cropnerf_tpu_torch import cli
from cropnerf_tpu_torch.core.cameras import Cameras
from cropnerf_tpu_torch.data import databank as tbank
from cropnerf_tpu_torch.export.ply import ply_vertex_count
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.models.model import model_init
from cropnerf_tpu_torch.parallel import dist as pdist
from cropnerf_tpu_torch.parallel.mesh import (Mesh, gather_in_order,
                                              pad_to_multiple)
from cropnerf_tpu_torch.train.trainer import load_trainer_from_run
from synthetic import ring_cameras
from test_torch_train import (KINK_TOL, _jax_loss_fn, _jax_rays, _kinked,
                              _leaf_name, _named)
from test_trainer import write_synthetic_dataset
from torch_parity import reduced_mxu

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_ddp_worker.py"
RANKS = 2
N_IMG, H, W = 5, 16, 16
RAYS = 32                 # the worker's batch: 16 rays a rank
JAX_STEP = 300
KEY_SEED = 4
# export's options in the worker's two-rank CLI run and the one-process one
EXPORT_ARGS = ["--num-points-per-side", "8", "--rays-per-batch", "32",
               "--semantic-threshold", "-100", "--density-threshold", "0"]
TIMEOUT_S = 150           # each rank's own limit


def _bank_arrays():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (N_IMG, H, W, 3), dtype=np.uint8)
    masks = (rng.rand(N_IMG, H, W) > 0.7).astype(np.uint8)
    c2w = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_IMG, 1, 1))
    c2w[:, :, 3] = (rng.randn(N_IMG, 3) * 0.5).astype(np.float32)
    f = np.full((N_IMG,), 14.0, np.float32)
    cams = dict(c2w=c2w, fx=f, fy=f.copy(),
                cx=np.full((N_IMG,), W / 2, np.float32),
                cy=np.full((N_IMG,), H / 2, np.float32),
                width=np.full((N_IMG,), W, np.int32),
                height=np.full((N_IMG,), H, np.int32))
    return images, masks, cams


def _jax_cams(cams):
    return JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()})


def _torch_cams(cams):
    return Cameras(**{k: torch.from_numpy(np.asarray(v))
                      for k, v in cams.items()})


def _jax_local_indices(local_pixels):
    """Each device's local pixel indices, derived as the JAX sharded step
    derives them (fold_in by device index, then split)."""
    key = jax.random.PRNGKey(KEY_SEED)
    out = []
    for di in range(RANKS):
        key_idx, _ = jax.random.split(jax.random.fold_in(key, di))
        out.append(np.asarray(jax.random.randint(
            key_idx, (RAYS // RANKS,), 0, local_pixels)))
    return np.stack(out)


def params_pair(preset: str, num_images: int, reduce=None, seed: int = 0):
    """(JAX params, the port's) with the same values: the port's
    ``model_init`` from a seeded generator, laid into the JAX params tree
    (its structure from ``jax.eval_shape``, leaf for leaf by name), which
    costs a fraction of a JAX ``model_init`` on the CPU."""
    reduce = reduce or (lambda presets: presets[preset])
    port = model_init(reduce(PRESETS).model, num_images,
                      torch.Generator().manual_seed(seed), "cpu")
    values = {k: v.detach().numpy() for k, v in port.named_parameters()}
    shapes = jax.eval_shape(
        lambda key: jax_model_init(key, reduce(JAX_PRESETS).model,
                                   num_images), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(values[_leaf_name(path)], s.dtype),
        shapes), port


def _launcher_env(rank: int, port: int, **extra) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(RANKS),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(RANKS),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               CROPNERF_PLATFORM="cpu", OMP_NUM_THREADS="2", **extra)
    env.pop("CROPNERF_FP32_MATMUL", None)
    return env


def run_ranks(cmd, cwd=REPO, **extra) -> list:
    """Run ``cmd`` once per rank with a launcher's environment; each rank
    has its own timeout, on whose expiry every rank is killed and the test
    fails.  Returns each rank's output."""
    port = pdist.free_port()
    procs = [subprocess.Popen(cmd, cwd=cwd, env=_launcher_env(r, port,
                                                              **extra),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank of {cmd} ran past {TIMEOUT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """One two-rank run of the worker: its inputs, and each rank's
    results."""
    work = tmp_path_factory.mktemp("ddp")
    images, masks, cams = _bank_arrays()
    n_pad = jbank.padded_num_images(N_IMG, RANKS)
    local_pixels = n_pad * H * W // RANKS
    ring = ring_cameras(n=3, height=24, width=24, focal=30.0)
    ring = {f.name: np.asarray(getattr(ring, f.name))
            for f in dataclasses.fields(ring)
            if getattr(ring, f.name) is not None}
    boxes = np.array([[[-0.2] * 3, [0.2] * 3], [[-0.6] * 3, [0.6] * 3]],
                     np.float32)
    np.savez(work / "inputs.npz", images=images, masks=masks,
             jax_idx=_jax_local_indices(local_pixels),
             aabb=np.array([[-1, -1, -1], [1, 1, 1]], np.float32),
             boxes=boxes, export_args=np.array(EXPORT_ARGS),
             **{f"cam_{k}": v for k, v in cams.items()},
             **{f"ring_{k}": v for k, v in ring.items()})
    jparams, tparams = params_pair("cropnerf-mxu", n_pad, reduced_mxu)
    torch.save(tparams.state_dict(), work / "mxu_params.pt")
    write_synthetic_dataset(work / "ds", n=6, size=16)
    outs = run_ranks([sys.executable, str(WORKER), str(work)])
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    return dict(work=work, ranks=ranks, jparams=jparams, outs=outs,
                inputs=dict(np.load(work / "inputs.npz")))


# ---- the padding and layout helpers -------------------------------------

@pytest.mark.parametrize("n_images,ranks", [(5, 2), (5, 4), (6, 2)])
def test_padding_helpers_match_jax(n_images, ranks, monkeypatch):
    images, masks, cams = _bank_arrays()
    images, masks = images[:n_images], masks[:n_images]
    cams = {k: v[:n_images] for k, v in cams.items()}
    n_pad = jbank.padded_num_images(n_images, ranks)
    assert tbank.padded_num_images(n_images, ranks) == n_pad
    assert pad_to_multiple(n_images, ranks) == n_pad
    ji, jm, jc = jbank.pad_images_for_sharding(images, masks,
                                               _jax_cams(cams), ranks)
    ti, tm, tc = tbank.pad_images_for_sharding(images, masks,
                                               _torch_cams(cams), ranks)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    for f in ("c2w", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    np.testing.assert_array_equal(
        tbank.pad_cameras(_torch_cams(cams), ranks).c2w.numpy(),
        np.asarray(jbank.pad_cameras(_jax_cams(cams), ranks).c2w))
    # JAX's range is by process: each rank is one process here
    monkeypatch.setattr(jax, "process_count", lambda: ranks)
    for r in range(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        mesh = Mesh(rank=r, size=ranks, device=torch.device("cpu"))
        assert (tbank.process_image_range(n_pad, mesh)
                == jbank.process_image_range(n_pad))


def test_sharded_bank_rows_equal_jax_shards(ddp):
    images, masks, cams = _bank_arrays()
    images, masks, jcams = jbank.pad_images_for_sharding(
        images, masks, _jax_cams(cams), RANKS)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:RANKS]), ("data",))
    jb = jbank.build_sharded_pixel_bank(images, masks, jcams, mesh)
    shards = sorted(jb.rgb.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    mask_shards = sorted(jb.mask.addressable_shards,
                         key=lambda s: s.index[0].start or 0)
    for r, res in enumerate(ddp["ranks"]):
        np.testing.assert_array_equal(res["bank_rgb"],
                                      np.asarray(shards[r].data))
        np.testing.assert_array_equal(res["bank_mask"],
                                      np.asarray(mask_shards[r].data))
        assert res["image_offset"] == r * jcams.num_cameras // RANKS
        assert res["num_images"] == jcams.num_cameras == 6


def _close(got, ref, what, kinked):
    if kinked:
        err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)
        assert err <= KINK_TOL["f32"], (what, err)
    else:
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
        assert err <= 1e-3, (what, err)


def test_sharded_step_matches_jax_device_average(ddp, monkeypatch):
    """The port's two-rank sharded step on the local indices JAX's RNG
    derives, against the average over devices of JAX's per-device loss
    and gradients on the same global pixels (float32, no jitter)."""
    monkeypatch.setenv("CROPNERF_FP32_MATMUL", "1")
    jax.clear_caches()
    try:
        jcfg = dataclasses.replace(reduced_mxu(JAX_PRESETS),
                                   train_num_rays_per_batch=RAYS)
        images, masks, cams = _bank_arrays()
        images, masks, jcams = jbank.pad_images_for_sharding(
            images, masks, _jax_cams(cams), RANKS)
        jb = jbank.build_pixel_bank(images, masks, jcams)
        local_pixels = jb.num_pixels // RANKS

        def device_grads(params, idx):
            loss_fn = _jax_loss_fn(jcfg, jb, idx, JAX_STEP)
            return jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                      has_aux=True)(
                params, *_jax_rays(jb, idx))

        run = jax.jit(device_grads)
        losses, grads, scale = [], [], np.zeros((6, 6), np.float32)
        for d in range(RANKS):
            idx = jnp.asarray(d * local_pixels + ddp["inputs"]["jax_idx"][d],
                              jnp.int32)
            (loss, aux), (g, g_o, g_d) = run(ddp["jparams"], idx)
            losses.append(aux)
            grads.append(_named(g))
            # camera_opt's bound: the rays' gradient magnitudes per camera
            cam = np.asarray(idx) // (H * W)
            np.add.at(scale[:, :3], cam, np.abs(np.asarray(g_o)) / RANKS)
            np.add.at(scale[:, 3:], cam,
                      np.linalg.norm(np.asarray(g_d), axis=1)[:, None]
                      / RANKS)
    finally:
        jax.clear_caches()
    got = ddp["ranks"][0]["jax_case"]
    for k in ("loss", "rgb_loss", "semantics_loss", "interlevel_loss",
              "distortion_loss"):
        ref = np.mean([float(a[k]) for a in losses])
        np.testing.assert_allclose(got[k], ref, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    ref = {k: np.mean([g[k] for g in grads], axis=0) for k in grads[0]}
    assert set(got["grads"]) == set(ref)
    for k, r in ref.items():
        if k != "camera_opt":
            _close(got["grads"][k].numpy(), r, k, _kinked(k))
    diff = np.abs(got["grads"]["camera_opt"].numpy() - ref["camera_opt"])
    assert np.all(diff <= KINK_TOL["f32"] * scale + 1e-7)
    # both ranks hold the same averaged gradients
    other = ddp["ranks"][1]["jax_case"]["grads"]
    assert all(torch.equal(other[k], v) for k, v in got["grads"].items())


def test_sharded_step_matches_the_replay_oracle(ddp):
    """Each rank ran assert_sharded_step_matches_replay (it raises on a
    gap); both report the largest deviation."""
    for res in ddp["ranks"]:
        assert 0.0 <= res["replay_max_dev"] <= 3e-5


def test_replicated_step_equals_the_one_process_step(ddp):
    """The replicated bank's two-rank step against the one-process step on
    the same global draws: loss and gradients to float32 reassociation,
    and both ranks' parameters bit for bit after three steps."""
    rep = ddp["ranks"][0]["replicated"]
    one, ranks = rep["one"], rep["ranks"]
    for k in ("loss", "rgb_loss", "semantics_loss", "distortion_loss"):
        np.testing.assert_allclose(ranks[k], one[k], rtol=1e-5, err_msg=k)
    for k, g in one["grads"].items():
        scale = float(g.abs().max())
        err = float((ranks["grads"][k] - g).abs().max())
        assert err <= 1e-5 * scale + 1e-9, (k, err, scale)
    p0, p1 = (res["replicated_params"] for res in ddp["ranks"])
    assert set(p0) == set(p1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("what", ["export", "project"])
def test_two_ranks_write_what_one_rank_writes(ddp, what):
    """export's PLY files (rows and their order) and project's PNG tree,
    byte for byte, from two ranks and from rank 0 alone."""
    ranks = _tree(ddp["work"] / f"{what}_ranks")
    one = _tree(ddp["work"] / f"{what}_one")
    assert len(one) == (3 if what == "export" else 12)
    assert ranks == one
    if what == "project":
        assert ddp["ranks"][0]["project_dispatches"] > 2 * RANKS


def test_gather_in_order_without_a_group_stops_where_asked():
    done = []

    def compute(i, prepared):
        done.append(i)
        return i, prepared

    out = list(gather_in_order(10, compute, None, prepare=lambda i: i * i,
                               should_stop=lambda: len(done) >= 4))
    assert out == [(i, (i, i * i)) for i in range(4)]


# ---- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def launched_run(ddp):
    """The worker's last case: train --multichip --shard-bank on through
    the CLI under the launcher's environment (two ranks, cropnerf-tiny, 3
    steps)."""
    return ddp["work"] / "run", ddp["outs"], ddp["work"] / "ds"


def test_launched_train_writes_one_run_like_jax(launched_run, tmp_path):
    run, outs, dataset = launched_run
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [
        "step-000000003.pt"]
    assert len((run / "logs" / "metrics.jsonl").read_text().splitlines()) \
        >= 2
    # rank 0 alone prints the final metrics
    assert sum('"loss"' in out for out in outs) == 1
    meta = json.loads((run / "run_config.json").read_text())
    # the JAX trainer's metadata writer on the fields a two-device mesh
    # with shard_bank=True gives it (the bank's padded image count, the
    # flag), without building its sharded bank and state
    data_cfg = JaxDataConfig(data_dir=dataset, train_split_fraction=0.8)
    outputs = jax_parse(data_cfg, "train")
    fields = SimpleNamespace(
        experiment_name="cropnerf", output_dir=tmp_path,
        num_train_images=jbank.padded_num_images(len(outputs.image_paths),
                                                 RANKS),
        shard_bank=True, semantic_threshold=SEMANTIC_THRESHOLD,
        cfg=JAX_PRESETS["cropnerf-tiny"], data_config=data_cfg,
        train_outputs=outputs)
    JaxTrainer._write_run_metadata(fields)
    ref = json.loads((tmp_path / "run_config.json").read_text())
    assert meta["shard_bank"] is True and meta["num_train_images"] == 6
    assert meta == ref


def test_launched_run_loads_and_serves_multichip_alone(launched_run,
                                                       monkeypatch, capsys,
                                                       tmp_path):
    """The sharded run's checkpoint loads at its padded image count;
    export --multichip with no launcher and no card says so and runs on
    the one device, and writes what the two ranks' export --multichip
    wrote, byte for byte."""
    run = launched_run[0].parent / "run_served"
    monkeypatch.setenv("CROPNERF_PLATFORM", "cpu")
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    trainer = load_trainer_from_run(run, device="cpu")
    assert trainer.state.step == 3
    assert trainer.state.params.camera_opt.shape[0] == 6
    paths = cli.main(["export", "--run-dir", str(run), "--multichip",
                      "--output-dir", str(tmp_path / "exp"), *EXPORT_ARGS])
    assert "only one device is visible — running single-device" in \
        capsys.readouterr().out
    assert _tree(tmp_path / "exp") == _tree(run.parent / "export_cli")
    assert ply_vertex_count(Path(paths["density"])) > 0


def test_shard_bank_without_a_group_exits(launched_run, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("CROPNERF_PLATFORM", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="--shard-bank requires"):
        cli.main(["train", "--method", "cropnerf-tiny", "--data",
                  str(launched_run[2]), "--output", str(tmp_path / "run"),
                  "--shard-bank", "on"])
