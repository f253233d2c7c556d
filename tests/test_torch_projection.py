"""The port's projection stage (cropnerf_tpu_torch/projection/project.py)
against the JAX package's, on a reduced cropnerf and a reduced
cropnerf-mxu with the same weights (carried by convert.py), in the
float32 arm (CROPNERF_FP32_MATMUL=1 in JAX, compute_dtype=float32 in the
port), at 32x32 ring cameras.

The random fields get a density bias (cropnerf +0.5, cropnerf-mxu 0) and a
semantic bias (+3) so that the images hold saturated and unsaturated
semantics and the visibility pass both occludes and keeps pixels."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cropnerf_tpu.models.config import PRESETS
from cropnerf_tpu.models.model import model_init
from cropnerf_tpu.projection import project as jproject
from cropnerf_tpu_torch.convert import params_from_jax
from cropnerf_tpu_torch.core.cameras import (Cameras, generate_rays,
                                             ray_aabb_intersect)
from cropnerf_tpu_torch.core.rays import RayBundle
from cropnerf_tpu_torch.models.model import forward_accumulation
from cropnerf_tpu_torch.projection import project
from synthetic import ring_cameras
from torch_parity import reduced_cropnerf, reduced_mxu

H = W = 32
N_CAMS = 3
TOL = 1e-4
ACC_BAND = 1e-3
BIASES = {"cropnerf": (0.5, 3.0), "cropnerf-mxu": (0.0, 3.0)}
BOXES = [
    np.array([[-0.2, -0.2, -0.2], [0.2, 0.2, 0.2]], np.float32),    # inside
    np.array([[2.4, -0.1, 0.2], [2.8, 0.1, 0.5]], np.float32),      # behind
    np.array([[0.0, 0.0, 0.0], [0.004, 0.004, 0.004]], np.float32),  # < 10 hits
    np.array([[-0.6, -0.6, -0.6], [0.6, 0.6, 0.6]], np.float32),    # full frame
]


def _cfg(name):
    return (reduced_cropnerf if name == "cropnerf" else reduced_mxu)(
        PRESETS).model


@pytest.fixture(scope="module")
def f32():
    """The float32 arm for the module: the JAX package reads
    CROPNERF_FP32_MATMUL while tracing, so compiled programs are dropped
    before and after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CROPNERF_FP32_MATMUL", "1")
        jax.clear_caches()
        yield
    jax.clear_caches()


def _scene(name):
    """JAX params and cameras, and the port's copies of both."""
    cfg = _cfg(name)
    tree = jax.tree_util.tree_map(
        np.array, model_init(jax.random.PRNGKey(0), cfg, N_CAMS))
    density, semantic = BIASES[name]
    f = tree["field"]
    if name == "cropnerf":
        f["mlp_base"]["b"][1][0] += density
        f["semantic_head"]["b"][0][0] += semantic
    else:
        f["mlp_top"]["b"][3][0] += density
        f["mlp_semantic"]["b"][1][0] += semantic
    jcams = ring_cameras(n=N_CAMS, height=H, width=W, focal=40.0)
    tcams = Cameras(**{f.name: torch.from_numpy(np.array(getattr(jcams,
                                                                 f.name)))
                       for f in dataclasses.fields(jcams)
                       if getattr(jcams, f.name) is not None})
    return (cfg, jax.tree_util.tree_map(jnp.array, tree), jcams,
            params_from_jax(tree, device="cpu"), tcams)


def _visibility_acc(params, cfg, cams, cam, aabb):
    """The visibility pass's accumulation over the whole image [H, W]."""
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    idx = torch.full((H * W,), cam, dtype=torch.long)
    o, d = generate_rays(cams, idx, xs.reshape(-1), ys.reshape(-1))
    nears, _, hit = ray_aabb_intersect(o, d, torch.from_numpy(aabb))
    rb = RayBundle(origins=o, directions=d, nears=torch.zeros_like(nears),
                   fars=nears.clamp(min=1e-4), camera_idx=idx, mask=hit)
    acc = forward_accumulation(params, rb, cfg, compute_dtype=torch.float32)
    return acc.reshape(H, W).numpy()


def _check_job(got, ref, acc, what):
    (wo, vis), (rwo, rvis) = got, ref
    np.testing.assert_allclose(wo, rwo, atol=TOL, rtol=0, err_msg=what)
    # occlusion may differ only where acc sits within ACC_BAND of 0.5
    differs = np.abs(vis - rvis) > TOL
    assert not (differs & (np.abs(acc - 0.5) >= ACC_BAND)).any(), what


JOBS = [(c, b) for c in range(N_CAMS) for b in BOXES]
INFO = np.array([{"aabb": np.stack([BOXES[3], BOXES[0]]),
                  "pcd": {0: np.zeros((1, 3)), 1: np.zeros((1, 3))}}],
                dtype=object)


def _labels(root):
    paths = []
    for c in range(N_CAMS):
        p = root / f"frame_{c:04d}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.full((H, W), c + 1, np.uint8)).save(p)
        paths.append(p)
    return paths


def _reference(name, tmp_path_factory):
    """The scene, the JAX projector's images of JOBS at a 256-ray budget
    and (for cropnerf) the JAX run_projections tree of INFO, all through
    one compiled program: the budget puts every crop through the same
    (256, 1) program, which run_projections reuses from the projector."""
    cfg, jp, jcams, tp, tcams = _scene(name)
    spr = (cfg.num_nerf_samples_per_ray
           + sum(cfg.num_proposal_samples_per_ray))
    proj = jproject.ClusterProjector(jp, cfg, jcams, H, W,
                                     max_samples_per_dispatch=256 * spr)
    images = {i: (w, v) for i, w, v in proj.iter_projections(JOBS)}
    tree = None
    if name == "cropnerf":
        tree = tmp_path_factory.mktemp("jax_tree")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jproject, "ClusterProjector",
                       lambda *args, **kwargs: proj)
            jproject.run_projections(jp, cfg, jcams, H, W, INFO, tree,
                                     label_paths=_labels(tree.parent /
                                                         "labels"))
    return dict(name=name, cfg=cfg, spr=spr, proj=proj, images=images,
                tree=tree, tp=tp, tcams=tcams)


@pytest.fixture(scope="module")
def references(f32, tmp_path_factory):
    return {name: _reference(name, tmp_path_factory)
            for name in ("cropnerf", "cropnerf-mxu")}


@pytest.mark.parametrize("name", ["cropnerf", "cropnerf-mxu"])
def test_projector_matches_jax(references, name):
    """Every job kind: a box inside the frame, one behind the camera
    (crop None), one with fewer than 10 hits and a full-frame box; with a
    256-ray budget the larger crops are oversized (rendered in row
    segments) on both sides."""
    r = references[name]
    cfg, tp, tcams = r["cfg"], r["tp"], r["tcams"]
    port = project.ClusterProjector(tp, cfg, tcams, H, W,
                                    max_samples_per_dispatch=256 * r["spr"],
                                    compute_dtype=torch.float32)
    assert port.max_rays_per_job == r["proj"].max_rays_per_job == 256
    _, oversized, zeros = r["proj"]._plan(JOBS)
    plan = port.plan(JOBS)
    assert plan.outside == zeros == [1, 5, 9]
    assert ({i for i, *_ in oversized}
            == {j.index for j in plan.jobs if j.n_pix > 256})
    assert len(oversized) >= N_CAMS
    assert all(sum(b - a for _, a, b in d) <= 256 for d in plan.dispatches)
    want = r["images"]
    got = {}
    for i, w, v in port.iter_projections(JOBS):
        assert i not in got
        got[i] = (w, v)
    assert sorted(got) == list(range(len(JOBS)))
    for i, (c, box) in enumerate(JOBS):
        acc = _visibility_acc(tp, cfg, tcams, c, box)
        _check_job(got[i], want[i], acc, f"{r['name']} job {i}")
    for i in (2, 6, 10):        # under 10 hits: zero images on both sides
        assert not got[i][0].any() and not want[i][0].any()
    # the fields' biases give the test something to compare
    assert sum(float(got[i][0].max() == 1.0) for i in got) >= 3
    kept = sum(int((got[i][1] > 0).sum()) for i in got)
    hidden = sum(int(((got[i][0] > 0) & (got[i][1] == 0)).sum())
                 for i in got)
    assert kept > 100 and hidden > 100


def test_crop_matches_jax():
    jcams = ring_cameras(n=N_CAMS, height=H, width=W, focal=40.0)
    host = project.HostCameras(*(np.asarray(getattr(jcams, k)) for k in
                                 ("c2w", "fx", "fy", "cx", "cy")))
    rng = np.random.default_rng(0)
    for _ in range(40):
        lo = rng.uniform(-1.5, 1.0, 3).astype(np.float32)
        box = np.stack([lo, lo + rng.uniform(0.01, 0.8, 3)]).astype(
            np.float32)
        for c in range(N_CAMS):
            assert (project._project_aabb_to_crop(host, c, box, H, W)
                    == jproject._project_aabb_to_crop(jcams, c, box, H, W))


def test_batched_matches_single():
    """Jobs batched into dispatches of another size, or laid across a
    dispatch's edge, give the images of one job at a time (the port of
    tests/test_export_projection.py's test_batched_matches_single)."""
    cfg, _, _, tp, tcams = _scene("cropnerf")
    kw = dict(compute_dtype=torch.float32)
    single = project.ClusterProjector(tp, cfg, tcams, H, W, **kw)
    ref = {i: single.project(c, b) for i, (c, b) in enumerate(JOBS)}
    for rays in (300, 2048):
        proj = project.ClusterProjector(tp, cfg, tcams, H, W,
                                        rays_per_dispatch=rays, **kw)
        plan = proj.plan(JOBS)
        assert len(plan.dispatches) > 1
        got = {i: (w, v) for i, w, v in proj.iter_projections(JOBS)}
        assert sorted(got) == sorted(ref)
        for i in ref:
            np.testing.assert_allclose(got[i][0], ref[i][0], atol=1e-5)
            np.testing.assert_allclose(got[i][1], ref[i][1], atol=1e-5)


def test_run_projections_writes_the_jax_tree(references, tmp_path, capsys):
    """The PNG tree file for file: the same files, label copies byte for
    byte, images within one 8-bit level (a 1e-4 float difference can
    cross a level), and the ValueError for a short label list."""
    r = references["cropnerf"]
    cfg, tp, tcams = r["cfg"], r["tp"], r["tcams"]
    labels = _labels(tmp_path / "labels")
    report = project.run_projections(tp, cfg, tcams, H, W, INFO,
                                     tmp_path / "port", label_paths=labels,
                                     compute_dtype=torch.float32)
    cap = min(262_144, 8_388_608 // r["spr"] // 128 * 128)
    jobs = N_CAMS * len(INFO[0]["aabb"])
    assert report.plan["jobs"] == jobs and report.plan["outside"] == 0
    assert report.plan["rays_per_dispatch"] == cap
    assert report.plan["dispatches"] == -(-report.plan["rays"] // cap) == 1
    assert "[project] render+stitch" in capsys.readouterr().out
    jax_tree, port_tree = r["tree"], tmp_path / "port"
    files = sorted(p.relative_to(jax_tree) for p in jax_tree.rglob("*.png"))
    assert files == sorted(p.relative_to(port_tree)
                           for p in port_tree.rglob("*.png"))
    assert len(files) == N_CAMS * (2 * 2 + 1)
    for rel in files:
        if rel.name.startswith("label_"):
            assert (jax_tree / rel).read_bytes() == \
                (port_tree / rel).read_bytes(), rel
            continue
        ia = np.asarray(Image.open(jax_tree / rel), np.int32)
        ib = np.asarray(Image.open(port_tree / rel), np.int32)
        assert np.abs(ia - ib).max() <= 1, rel
    assert any(np.asarray(Image.open(port_tree / rel)).any()
               for rel in files if rel.name.startswith("visible"))
    with pytest.raises(ValueError, match="one label image per camera"):
        project.run_projections(tp, cfg, tcams, H, W, INFO, tmp_path / "x",
                                label_paths=labels[:2])
