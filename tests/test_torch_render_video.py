"""The port's orbit cameras and camera-pose export
(evaluation/render_video.py) and its profiling helpers (utils/profiling.py)
against the JAX package.  Cameras and poses agree to 1e-6."""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import torch

from cropnerf_tpu.core.cameras import Cameras as JaxCameras
from cropnerf_tpu.evaluation import render_video as jrv
from cropnerf_tpu_torch.core.cameras import Cameras
from cropnerf_tpu_torch.evaluation import render_video as trv
from cropnerf_tpu_torch.utils.profiling import StepTimer, device_trace

TOL = 1e-6


def test_orbit_cameras_match_jax():
    ref = jrv.orbit_cameras(5, radius=1.1, height=0.2, center=(0.1, 0, 0),
                            focal=300.0, width=64, image_height=48)
    got = trv.orbit_cameras(5, radius=1.1, height=0.2, center=(0.1, 0, 0),
                            focal=300.0, width=64, image_height=48,
                            device="cpu")
    for k in ("c2w", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=TOL,
                                   err_msg=k)
        assert getattr(got, k).numpy().dtype == np.asarray(
            getattr(ref, k)).dtype, k


def test_camera_pose_export_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    c2w = rng.standard_normal((4, 3, 4)).astype(np.float32)
    adj = (rng.standard_normal((4, 6)) * 0.05).astype(np.float32)
    f = np.full((4,), 50.0, np.float32)
    size = np.full((4,), 32, np.int32)
    cams = dict(c2w=c2w, fx=f, fy=f, cx=f / 2, cy=f / 2, width=size,
                height=size)
    jcams = JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()})
    tcams = Cameras(**{k: torch.from_numpy(v) for k, v in cams.items()})
    for pose in (None, adj):
        ref = jrv.collect_camera_poses(
            jcams, None if pose is None else jnp.asarray(pose))
        got = trv.collect_camera_poses(
            tcams, None if pose is None else torch.from_numpy(pose))
        assert [g["file_path"] for g in got] == [r["file_path"] for r in ref]
        np.testing.assert_allclose([g["transform"] for g in got],
                                   [r["transform"] for r in ref], atol=TOL)
    paths = trv.export_camera_poses(tmp_path, tcams, tcams,
                                    torch.from_numpy(adj))
    assert sorted(paths) == ["eval", "train"]
    train = json.loads(paths["train"].read_text())["frames"]
    ev = json.loads(paths["eval"].read_text())["frames"]
    np.testing.assert_allclose(np.array(ev[0]["transform"])[:3],
                               c2w[0], atol=TOL)
    assert not np.allclose(np.array(train[0]["transform"])[:3], c2w[0])


def test_step_timer_and_device_trace(tmp_path):
    timer = StepTimer(rays_per_step=1024)
    assert timer.tick() == {}
    out = timer.tick()
    assert set(out) == {"step_time_ms", "rays_per_s"}
    assert timer.total_steps == 1 and timer.mean_rays_per_s > 0
    with device_trace(tmp_path / "trace") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert (tmp_path / "trace" / "trace.json").is_file()
    assert any("mm" in e.key for e in prof.key_averages())
