"""The port's trainer (train/trainer.py) and its data loaders against the
JAX package's on cropnerf-tiny and the 6-view 32x32 synthetic dataset of
tests/test_trainer.py.

One JAX Trainer serves the file: its initial parameters (the eval image,
taken before it trains), then a 4-step run with the eval cadences at 2 or
4 (metrics.jsonl, eval_images) and orbax checkpoints at steps 3 and 4,
which tools/jax_run_to_torch.py converts.  The save cadence is 3 because
the JAX trainer saves again at the end of a run, and orbax refuses to
write the same step twice.  Both packages run their float32 arm
(``CROPNERF_FP32_MATMUL=1``; the port's render in float32), so the eval
metrics agree within the renderer's fp32-arm tolerance, 1e-4
(tests/torch_parity.py ARM_TOL).  Parsing and loading agree exactly
(cameras to 1e-6); checkpoints round-trip bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from cropnerf_tpu.data.dataparser import (DataparserConfig as JaxDataConfig,
                                          parse_transforms as jax_parse)
from cropnerf_tpu.data.dataset import load_split as jax_load_split
from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.train.trainer import Trainer as JaxTrainer
from cropnerf_tpu_torch.convert import params_from_jax
from cropnerf_tpu_torch.data.dataparser import DataparserConfig, parse_transforms
from cropnerf_tpu_torch.data.dataset import load_split
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.train.step import make_render_fn
from cropnerf_tpu_torch.train.trainer import Trainer, load_trainer_from_run
from test_trainer import write_synthetic_dataset
from torch_parity import ARM_TOL
from tools.jax_run_to_torch import convert_run, restore_jax_checkpoint

CADENCES = dict(steps_per_eval_batch=2, steps_per_eval_image=4,
                steps_per_eval_all_images=4, steps_per_save=3)
STEPS = 4
SPLIT = 0.8


def _cfg(presets):
    return dataclasses.replace(presets["cropnerf-tiny"], **CADENCES)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("ds"), n=6,
                                   size=32)


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """The JAX trainer's initial params and eval image, then its 4-step
    run directory, all in the float32 arm."""
    run_dir = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CROPNERF_FP32_MATMUL", "1")
        jax.clear_caches()
        trainer = JaxTrainer(_cfg(JAX_PRESETS), JaxDataConfig(
            data_dir=dataset, train_split_fraction=SPLIT), run_dir)
        init = jax.tree_util.tree_map(np.array,
                                      jax.device_get(trainer.state.params))
        eval0 = trainer.eval_image(0)
        trainer.train(num_steps=STEPS, log_every=2)
        final = jax.tree_util.tree_map(np.array,
                                       jax.device_get(trainer.state.params))
        bank = (np.asarray(trainer.bank.rgb), np.asarray(trainer.bank.mask))
        jax.clear_caches()
    return dict(dir=run_dir, init=init, eval0=eval0, final=final, bank=bank)


def _port_trainer(dataset, run_dir, **kw):
    return Trainer(_cfg(PRESETS), DataparserConfig(
        data_dir=dataset, train_split_fraction=SPLIT), run_dir,
        device="cpu", **kw)


@pytest.fixture(scope="module")
def port_run(dataset, tmp_path_factory):
    """The port's 4-step run with the JAX run's cadences."""
    run_dir = tmp_path_factory.mktemp("port_run")
    trainer = _port_trainer(dataset, run_dir)
    metrics = trainer.train(num_steps=STEPS, log_every=2)
    return dict(dir=run_dir, trainer=trainer, metrics=metrics)


@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("threshold", [3, "fruit"])
def test_parse_and_load_split_equal_jax(dataset, split, threshold):
    ref = jax_parse(JaxDataConfig(data_dir=dataset,
                                  train_split_fraction=SPLIT), split)
    got = parse_transforms(DataparserConfig(data_dir=dataset,
                                            train_split_fraction=SPLIT), split)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    images, masks = load_split(got, semantic_threshold=threshold)
    ref_images, ref_masks = jax_load_split(ref, semantic_threshold=threshold)
    assert images.dtype == ref_images.dtype == np.uint8
    assert masks.dtype == ref_masks.dtype == np.uint8
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(masks, ref_masks)
    assert masks.any()


def test_bank_equals_jax(port_run, jax_run):
    bank = port_run["trainer"].bank
    np.testing.assert_array_equal(bank.rgb.numpy(), jax_run["bank"][0])
    np.testing.assert_array_equal(bank.mask.numpy(), jax_run["bank"][1])
    assert bank.rgb.dtype == torch.uint8 and bank.num_images == 5


@pytest.mark.parametrize("name", ["run_config.json",
                                  "dataparser_transforms.json"])
def test_run_metadata_equals_jax(port_run, jax_run, name):
    got = json.loads((port_run["dir"] / name).read_text())
    ref = json.loads((jax_run["dir"] / name).read_text())
    # both runs read the same dataset, so no path differs
    assert got == ref


def test_eval_image_matches_jax_on_the_same_params(dataset, jax_run,
                                                   tmp_path):
    trainer = _port_trainer(dataset, tmp_path / "run")
    trainer.state.params.load_state_dict(
        params_from_jax(jax_run["init"], device="cpu").state_dict())
    trainer.render = make_render_fn(trainer.cfg, compute_dtype=torch.float32)
    got = trainer.eval_image(0)
    ref = jax_run["eval0"]
    assert sorted(got) == sorted(ref) == ["eval_iou", "eval_psnr",
                                          "eval_ssim"]
    tol = ARM_TOL["f32"]
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=tol, abs=tol), k


def _keys_by_step_and_prefix(run_dir):
    out = defaultdict(set)
    for line in (run_dir / "logs" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        for k in rec:
            if "/" in k:
                prefix, name = k.split("/", 1)
                out[(rec["step"], prefix)].add(name)
    return dict(out)


def test_run_logs_the_jax_keys_and_eval_images(port_run, jax_run):
    got = _keys_by_step_and_prefix(port_run["dir"])
    ref = _keys_by_step_and_prefix(jax_run["dir"])
    assert got == ref
    assert sorted(got) == [(2, "eval"), (2, "train"), (4, "eval"),
                           (4, "eval_all"), (4, "train")]

    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*.png"))
    names = files(port_run["dir"] / "eval_images")
    assert names == files(jax_run["dir"] / "eval_images")
    assert names == [f"step_000000004/{n}.png" for n in
                     ("accumulation", "depth", "img", "semantics")]
    m = port_run["metrics"]
    assert m["step"] == STEPS and np.isfinite(m["loss"])
    assert m["rays_per_s"] > 0 and m["rays_per_s_window"] > 0
    for k in ("eval_batch_loss", "eval_psnr", "all_eval_ssim"):
        assert np.isfinite(m[k]), k


def _optimizer_states_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa["param_groups"] == sb["param_groups"]
        assert sa["state"].keys() == sb["state"].keys()
        for i in sa["state"]:
            for k, v in sa["state"][i].items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)
                assert v.device == sb["state"][i][k].device, (i, k)


def test_checkpoint_resume_is_bit_for_bit(port_run, dataset):
    trainer = port_run["trainer"]
    names = sorted(p.name for p in (port_run["dir"] / "checkpoints").iterdir())
    assert names == ["step-000000003.pt", "step-000000004.pt"]
    for reloaded in (_port_trainer(dataset, port_run["dir"], resume=True),
                     load_trainer_from_run(port_run["dir"], device="cpu")):
        assert reloaded.state.step == trainer.state.step == STEPS
        sd, ref = reloaded.state.params.state_dict(), trainer.state.params.state_dict()
        assert sd.keys() == ref.keys()
        for k in ref:
            assert torch.equal(sd[k], ref[k]), k
        _optimizer_states_equal(reloaded.state.optimizer.state_dict(),
                                trainer.state.optimizer.state_dict())


def test_resume_carries_the_step_on(port_run, dataset, tmp_path):
    import shutil
    run = tmp_path / "run"
    shutil.copytree(port_run["dir"], run)
    trainer = _port_trainer(dataset, run, resume=True)
    trainer.train(num_steps=2, log_every=2)
    assert trainer.state.step == STEPS + 2
    assert (run / "checkpoints" / "step-000000006.pt").exists()
    lr = {g["name"]: g["lr"] for g in trainer.state.optimizer.param_groups}
    from cropnerf_tpu_torch.train.optim import group_schedules
    sched = group_schedules(trainer.cfg)
    assert lr == {g: sched[g](STEPS + 1) for g in lr}


def test_jax_run_converts_and_loads(jax_run):
    run = jax_run["dir"]
    out = convert_run(run, run / "checkpoints" / "step-000000003")
    ckpt = torch.load(out, weights_only=True)
    assert out.name == "step-000000003.pt" and ckpt["step"] == 3
    restored = restore_jax_checkpoint(run, run / "checkpoints" /
                                      "step-000000003")
    ref = params_from_jax(restored["params"], device="cpu").state_dict()
    for k in ref:
        assert torch.equal(ckpt["params"][k], ref[k]), k
    # every parameter's moments and step, from optax's mu / nu / count
    states = [s for opt in ckpt["optimizers"] for s in opt["state"].values()]
    assert len(states) == len(ref)
    assert all(float(s["step"]) == 3.0 for s in states)
    assert all(float(s["exp_avg_sq"].abs().sum()) > 0 for s in states
               if float(s["exp_avg"].abs().sum()) > 0)

    # the newest (orbax) checkpoint must be converted before the port loads
    with pytest.raises(ValueError, match="jax_run_to_torch"):
        load_trainer_from_run(run, device="cpu")
    convert_run(run)
    trainer = load_trainer_from_run(run, device="cpu")
    assert trainer.state.step == STEPS
    ref = params_from_jax(jax_run["final"], device="cpu").state_dict()
    got = trainer.state.params.state_dict()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_params_only_checkpoint_loads_with_a_fresh_optimizer(port_run,
                                                             dataset,
                                                             tmp_path):
    trainer = port_run["trainer"]
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    torch.save({"params": trainer.state.params.state_dict(), "step": 7},
               run / "checkpoints" / "step-000000007.pt")
    reloaded = _port_trainer(dataset, run, resume=True)
    assert reloaded.state.step == 7
    assert all(not opt.state for opt in reloaded.state.optimizer.optimizers)
    ref = trainer.state.params.state_dict()
    got = reloaded.state.params.state_dict()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
