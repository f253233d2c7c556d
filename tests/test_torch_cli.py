"""The port's CLI (cropnerf_tpu_torch/cli.py) on the CPU
(``CROPNERF_PLATFORM=cpu``): each command's options against the JAX
CLI's, and the model commands on one tiny run directory (cropnerf-tiny,
4 steps, the 6-view 32x32 dataset of tests/test_trainer.py)."""
from __future__ import annotations

import argparse
import json

import numpy as np
import pytest
import torch
from PIL import Image

from cropnerf_tpu import cli as jcli
from cropnerf_tpu_torch import cli
from cropnerf_tpu_torch.export.ply import read_ply
from cropnerf_tpu_torch.export.volume import export_and_write
from cropnerf_tpu_torch.train.trainer import load_trainer_from_run
from test_trainer import write_synthetic_dataset

# options of the JAX CLI the port leaves out: none
OMITTED = set()
JAX_ADDERS = {"train": jcli._add_train, "export": jcli._add_export,
              "export-pointcloud": jcli._add_export_pointcloud,
              "segment": jcli._add_segment, "project": jcli._add_project,
              "count": jcli._add_count,
              "depth-project": jcli._add_depth_project,
              "depth-count": jcli._add_depth_count,
              "render": jcli._add_render,
              "uncertainty": jcli._add_uncertainty,
              "process-labels": jcli._add_process_labels,
              "rescale": jcli._add_rescale,
              "segment-masks": jcli._add_segment_masks,
              "import-colmap": jcli._add_import_colmap,
              "viewer": jcli._add_viewer}
EXPORT_THRESHOLDS = ["--semantic-threshold", "-100", "--density-threshold",
                     "0", "--colormap-threshold", "0.1"]


def _options(parser: argparse.ArgumentParser) -> dict:
    """option string → (dest, default, choices, nargs, required)."""
    return {s: (a.dest, a.default, a.choices, a.nargs, a.required)
            for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


@pytest.mark.parametrize("command", sorted(JAX_ADDERS))
def test_command_options_match_jax(command):
    jparser = argparse.ArgumentParser()
    JAX_ADDERS[command](jparser.add_subparsers())
    ref = _options(jparser._subparsers._group_actions[0].choices[command])
    got = _options(cli.build_parser()._subparsers._group_actions[0]
                   .choices[command])
    assert got == {k: v for k, v in ref.items() if k not in OMITTED}
    assert set(ref) - set(got) <= OMITTED


def test_the_port_has_every_jax_command():
    port = set(cli.build_parser()._subparsers._group_actions[0].choices)
    jax_commands = set()

    class _Sub:
        def add_parser(self, name, **kwargs):
            jax_commands.add(name)
            return argparse.ArgumentParser()

    for name in dir(jcli):
        if name.startswith("_add_") and name != "_add_multichip_flag":
            getattr(jcli, name)(_Sub())
    assert len(jax_commands) == 15
    assert port == jax_commands == set(JAX_ADDERS)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    data = write_synthetic_dataset(tmp_path_factory.mktemp("ds"), n=6,
                                   size=32)
    run = tmp_path_factory.mktemp("run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CROPNERF_PLATFORM", "cpu")
        cli.main(["train", "--method", "cropnerf-tiny", "--data", str(data),
                  "--output", str(run), "--max-steps", "4",
                  "--train-split-fraction", "0.8"])
    return run


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("CROPNERF_PLATFORM", "cpu")


def test_train_writes_the_run_layout(run_dir, on_cpu):
    for name in ("run_config.json", "dataparser_transforms.json",
                 "logs/metrics.jsonl", "checkpoints/step-000000004.pt"):
        assert (run_dir / name).is_file(), name
    meta = json.loads((run_dir / "run_config.json").read_text())
    assert meta["config"]["model"]["field"]["hidden_dim"] == 16
    assert meta["num_train_images"] == 5 and meta["shard_bank"] is False
    last = json.loads((run_dir / "logs" / "metrics.jsonl")
                      .read_text().splitlines()[-1])
    assert last["step"] == 4 and np.isfinite(last["eval_all/eval_psnr"])


def test_export_equals_a_direct_export(run_dir, on_cpu, tmp_path):
    cli.main(["export", "--run-dir", str(run_dir), "--num-points-per-side",
              "12", "--rays-per-batch", "64", "--output-dir",
              str(tmp_path / "cli"), *EXPORT_THRESHOLDS])
    trainer = load_trainer_from_run(run_dir, device="cpu")
    paths = export_and_write(
        trainer.state.params, trainer.cfg.model,
        trainer.train_outputs.scene_box, tmp_path / "direct",
        dataparser_scale=2.0, num_points_per_side=12, rays_per_batch=64,
        semantic_threshold=-100.0, density_threshold=0.0,
        colormap_threshold=0.1)
    for name, path in paths.items():
        pts, cols = read_ply(path)
        got_pts, got_cols = read_ply(tmp_path / "cli" / f"{name}.ply")
        assert len(pts) > 0, name
        np.testing.assert_array_equal(got_pts, pts)
        np.testing.assert_array_equal(got_cols, cols)


def test_export_pointcloud(run_dir, on_cpu, capsys):
    out = run_dir / "exports" / "pc.ply"
    cli.main(["export-pointcloud", "--run-dir", str(run_dir), "--output",
              str(out), "--num-points", "300", "--rays-per-batch", "128",
              "--all-points", "--accumulation-threshold", "0.0"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pts, _ = read_ply(out)
    assert res["num_points"] == len(pts) > 0
    assert np.isfinite(pts).all()


def test_render_and_export_cameras(run_dir, on_cpu, capsys):
    out = run_dir / "orbit.mp4"
    cli.main(["render", "--run-dir", str(run_dir), "--n-frames", "1",
              "--size", "16", "--output", str(out), "--eval-metrics",
              "--export-cameras"])
    lines = capsys.readouterr().out.strip().splitlines()
    metrics = json.loads(lines[-1])
    assert set(metrics) == {"eval_psnr", "eval_ssim", "eval_iou"}
    assert all(np.isfinite(v) for v in metrics.values())
    # an mp4 where imageio has a video backend, else a PNG frame directory
    assert out.is_file() or (out.with_suffix("") / "frame_0000.png").is_file()
    frames = json.loads((run_dir / "transforms_train.json").read_text())
    assert len(frames["frames"]) == 5


def test_uncertainty(run_dir, on_cpu):
    out = run_dir / "unc_test.npy"
    cli.main(["uncertainty", "--run-dir", str(run_dir), "--iters", "1",
              "--lod", "4", "--rays-per-batch", "64", "--output", str(out)])
    grid = np.load(out)
    assert grid.shape == ((2 ** 4 + 1) ** 3,)
    assert np.isfinite(grid).all() and grid.max() > 0


@pytest.mark.parametrize("platform, err, match", [
    (None, RuntimeError, "no CUDA device"),
    ("tpu", RuntimeError, "Expected one of"),
    ("xla", ValueError, "runs on 'cuda' or 'cpu'")])
def test_cli_raises_without_a_card_or_with_another_platform(
        run_dir, monkeypatch, platform, err, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if platform is None:
        monkeypatch.delenv("CROPNERF_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("CROPNERF_PLATFORM", platform)
    with pytest.raises(err, match=match):
        cli.main(["export", "--run-dir", str(run_dir)])
    with pytest.raises(err, match=match):
        cli.main(["train", "--data", str(run_dir), "--output",
                  str(run_dir / "never")])
    assert not (run_dir / "never").exists()


def test_train_in_process_gives_the_signal_handlers_back(run_dir, on_cpu,
                                                         tmp_path):
    import signal
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    meta = json.loads((run_dir / "run_config.json").read_text())
    trainer = cli.main(["train", "--method", "cropnerf-tiny", "--data",
                        meta["data_config"]["data_dir"], "--output",
                        str(tmp_path / "run"), "--max-steps", "2",
                        "--steps-per-dispatch", "2",
                        "--train-split-fraction", "0.8"])
    assert trainer.state.step == 2 and trainer.steps_per_dispatch == 2
    assert {s: signal.getsignal(s) for s in before} == before


@pytest.mark.parametrize("remat", ["on", "off"])
def test_train_remat_and_watchdog_options(run_dir, on_cpu, tmp_path, remat):
    """``--remat`` lands in the run's model config (the preset's own
    ``remat`` is off), and ``--min-rays-per-s`` arms the watchdog."""
    meta = json.loads((run_dir / "run_config.json").read_text())
    assert meta["config"]["model"]["remat"] is False
    trainer = cli.main(["train", "--method", "cropnerf-tiny", "--data",
                        meta["data_config"]["data_dir"], "--output",
                        str(tmp_path / "run"), "--max-steps", "1",
                        "--train-split-fraction", "0.8", "--remat", remat,
                        "--min-rays-per-s", "1e15"])
    written = json.loads((tmp_path / "run" / "run_config.json").read_text())
    assert written["config"]["model"]["remat"] is (remat == "on")
    assert trainer.cfg.model.remat is (remat == "on")
    assert trainer.min_rays_per_s == 1e15 and trainer._slow_retries == 0


def test_project_on_the_run(run_dir, on_cpu, capsys):
    """`project` loads the run and projects through the training cameras
    at the bank's size: every job's two images and each camera's label."""
    pcd = run_dir / "exports"
    pcd.mkdir(exist_ok=True)
    box = np.array([[-0.3, -0.3, -0.3], [0.3, 0.3, 0.3]], np.float32)
    info = np.array([{"aabb": np.stack([box, box * 0.5]),
                      "pcd": {0: np.zeros((1, 3)), 1: np.zeros((1, 3))}}],
                    dtype=object)
    np.save(pcd / "all_super_cluster_info_nsub_2.npy", info,
            allow_pickle=True)
    labels = run_dir / "labels"
    labels.mkdir(exist_ok=True)
    for i in range(5):
        Image.fromarray(np.full((32, 32), i, np.uint8)).save(
            labels / f"label_frame_{i:04d}.png")
    out = run_dir / "projection_test"
    report = cli.main(["project", "--run-dir", str(run_dir), "--pcd-dir",
                       str(pcd), "--output-dir", str(out), "--label-dir",
                       str(labels)])
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(out)
    assert report.plan["jobs"] == 5 * 2
    for c in range(5):
        cam = out / "super_cluster_0" / f"cam_{c}"
        names = sorted(p.name for p in cam.iterdir())
        assert names == [f"label_frame_{c:04d}.png",
                         "visible_cluster_0.png", "visible_cluster_1.png",
                         "wo_occ_cluster_0.png", "wo_occ_cluster_1.png"]
        assert Image.open(cam / "wo_occ_cluster_0.png").size == (32, 32)


def test_project_raises_without_a_card(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CROPNERF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["project", "--run-dir", str(run_dir), "--pcd-dir",
                  str(run_dir)])
