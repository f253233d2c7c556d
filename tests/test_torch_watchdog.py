"""The port trainer's throughput watchdog (train/trainer.py
``min_rays_per_s``): counterparts of the JAX trainer's five watchdog tests
(tests/test_trainer.py TestThroughputWatchdog) on cropnerf-tiny, 64 rays
a step (and 64 an eval batch), the 6-view 32x32 synthetic dataset, on
the CPU.  The windows are the JAX tests' with the step counts cut
(logging every 2 steps where JAX logs every 10), which the watchdog's
bookkeeping does not see."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

from cropnerf_tpu_torch.data.dataparser import DataparserConfig
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.train import trainer as trainer_mod
from cropnerf_tpu_torch.train.trainer import _MAX_SLOW_RETRIES, Trainer
from cropnerf_tpu_torch.utils.writer import MetricsWriter
from test_trainer import write_synthetic_dataset


@pytest.fixture(autouse=True)
def _jsonl_log_only(monkeypatch):
    """The watchdog reads no TensorBoard event: these runs write the JSONL
    log alone, which spares a process TensorBoard's import (about 15 s on
    the CPU)."""
    monkeypatch.setattr(trainer_mod, "MetricsWriter", functools.partial(
        MetricsWriter, use_tensorboard=False))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_synthetic_dataset(tmp_path_factory.mktemp("ds"))


def _trainer(dataset, run_dir, **kw):
    cfg = dataclasses.replace(PRESETS["cropnerf-tiny"],
                              train_num_rays_per_batch=64,
                              eval_num_rays_per_batch=64,
                              steps_per_eval_batch=10_000,
                              steps_per_eval_image=10_000,
                              steps_per_save=10_000)
    data_cfg = DataparserConfig(data_dir=dataset, train_split_fraction=0.8)
    return Trainer(cfg, data_cfg, run_dir, device="cpu", **kw)


def test_triggers_rebuild_and_still_trains(dataset, tmp_path, capsys):
    """An absurd floor makes every window after the first too slow: the
    trainer rebuilds the step at most _MAX_SLOW_RETRIES times (the window
    after each rebuild is exempt) and trains on."""
    t = _trainer(dataset, tmp_path / "run", min_rays_per_s=1e15)
    first = t.train_step
    metrics = t.train(num_steps=8, log_every=2)
    assert t._slow_retries == _MAX_SLOW_RETRIES
    assert t.train_step is not first
    assert t.state.step == 8
    assert np.isfinite(metrics["loss"])
    assert metrics["rays_per_s_window"] > 0
    out = capsys.readouterr().out
    # windows at steps 4 and 8 rebuild; 2 (the first) and 6 are exempt
    assert [line.split("]")[0] for line in out.splitlines()
            if "rebuilding the train step" in line] == ["[step 4",
                                                        "[step 8"]


def test_disabled_by_default(dataset, tmp_path):
    t = _trainer(dataset, tmp_path / "run")
    first = t.train_step
    t.train(num_steps=4, log_every=2)
    assert t._slow_retries == 0 and t.train_step is first


def test_eval_windows_exempt_from_floor(dataset, tmp_path):
    """Windows whose wall time holds eval work do not trigger the
    watchdog: with evals inside every logging window and an absurd floor,
    no rebuild fires."""
    t = _trainer(dataset, tmp_path / "run", min_rays_per_s=1e15)
    # evals at steps 1, 3, 5... land inside every logging window
    t.cfg = dataclasses.replace(t.cfg, steps_per_eval_batch=1)
    t.train(num_steps=8, log_every=2)
    assert t._slow_retries == 0


def test_warns_when_every_window_busy_exempt(dataset, tmp_path, capsys):
    """10 busy-exempt windows in a row give the one-time notice that the
    floor is effectively off, once even over more windows."""
    t = _trainer(dataset, tmp_path / "run", min_rays_per_s=1e15)
    # evals at steps 1, 3, 5... (an eval on a logging step is charged to
    # no window: the window re-arms after it)
    t.cfg = dataclasses.replace(t.cfg, steps_per_eval_batch=1)
    t.train(num_steps=24, log_every=2)     # 12 windows, all with evals
    assert t._slow_retries == 0
    out = capsys.readouterr().out
    assert out.count("exempted from the throughput floor") == 1


def test_gives_up_loudly_after_retries(dataset, tmp_path, capsys):
    """With the rebuilds spent and the rate still under the floor, the
    trainer warns once instead of degrading silently."""
    t = _trainer(dataset, tmp_path / "run", min_rays_per_s=1e15)
    t.train(num_steps=16, log_every=2)
    assert t._slow_retries == _MAX_SLOW_RETRIES
    assert t._watchdog_gave_up
    out = capsys.readouterr().out
    assert out.count("giving up") == 1
