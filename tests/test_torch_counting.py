"""The port's counting stage against the JAX package's, on the same inputs
made from numpy seeds: the merger (count_instances, the `count` command,
its result cloud and overlays), the segmenter (process_for_pipeline,
`segment`), the NeRF-free depth projection (`depth-project`,
`depth-count`) and the native point-cloud backend, which the port builds
from its own copy of the source."""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from cropnerf_tpu import cli as jcli
from cropnerf_tpu.counting import merger as jmerger
from cropnerf_tpu.native import pointcloud_ops as jnat
from cropnerf_tpu_torch import cli
from cropnerf_tpu_torch.counting import merger
from cropnerf_tpu_torch.export.ply import write_ply
from cropnerf_tpu_torch.native import pointcloud_ops as nat
from test_counting import make_grouped_tree
from test_depth_projection import look_at_camera


def blobs(centers, n=300, scale=0.01, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, scale, (n, 3)) for c in centers]
                          ).astype(np.float32)


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tree(root):
    """Two superclusters: six subclusters of three instances with 10 %
    label noise and one subcluster never seen, and six of two instances."""
    info = [make_grouped_tree(root / "super_cluster_0", [1, 1, 2, 2, 3, 3],
                              n_cams=8, noise=0.1, seed=3,
                              occluded={(c, 5) for c in range(8)}),
            make_grouped_tree(root / "super_cluster_1", [1, 1, 1, 2, 2, 2],
                              n_cams=8,
                              seed=4)]
    return np.array(info, dtype=object)


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("partition", ["clique", "bridge", "community"])
@pytest.mark.parametrize("attach", [False, True])
def test_count_instances_matches_jax(tmp_path, partition, attach):
    info = _tree(tmp_path)
    cfg = dict(graph_partition=partition, frame_sampling_interval=1,
               attach_unlabeled=attach)
    ref = jmerger.count_instances(tmp_path, info,
                                  jmerger.MergerConfig(**cfg))
    got = merger.count_instances(tmp_path, info, merger.MergerConfig(**cfg))
    assert got.total_count == ref.total_count
    assert got.per_super_cluster == ref.per_super_cluster
    for a, b in zip(got.affinities, ref.affinities, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.labels, ref.labels, strict=True):
        np.testing.assert_array_equal(a, b)
    assert got.total_count >= 3


def test_count_command_matches_jax(tmp_path, capsys):
    """`count` through both CLIs on copies of one tree, with the label
    refresh, the rescale and the overlays: the same JSON, the same result
    cloud and the same files in the tree afterwards."""
    src = tmp_path / "src"
    info = _tree(src / "projection")
    (src / "pcd").mkdir()
    np.save(src / "pcd" / "all_super_cluster_info_nsub_6.npy", info,
            allow_pickle=True)
    labels = src / "labels"
    labels.mkdir()
    for c in range(8):
        shutil.copy(src / "projection" / "super_cluster_0" / f"cam_{c}" /
                    "label_frame_0000.png", labels / f"label_frame_{c}.png")
    outs = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        root = tmp_path / name
        shutil.copytree(src, root)
        main(["count", "--projection-dir", str(root / "projection"),
              "--pcd-dir", str(root / "pcd"), "--k", "6",
              "--frame-sampling-interval", "1", "--overlays",
              "--label-dir", str(root / "labels"), "--scale-factor", "0.5",
              "--binary-threshold", "50", "--graph-partition", "community"])
        outs[name] = _json_out(capsys)
    assert outs["port"] == outs["jax"]
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path /
                                                            "port")
    assert port_files.keys() == jax_files.keys()
    assert any("overlay" in str(k) for k in port_files)
    for k in jax_files:
        assert port_files[k] == jax_files[k], k


def test_process_for_pipeline_matches_jax(tmp_path, capsys):
    """`segment` on one PLY: the same supercluster .npy, byte for byte."""
    pts = np.concatenate([
        blobs([[0, 0, 0], [0.03, 0, 0]], n=400, scale=0.008, seed=1),
        blobs([[0.5, 0.5, 0.1]], n=500, scale=0.01, seed=2),
        np.random.default_rng(3).uniform(-1, 1, (40, 3)).astype(np.float32)])
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        (tmp_path / name).mkdir()
        write_ply(tmp_path / name / "semantic.ply", pts)
        main(["segment", "--pcd-dir", str(tmp_path / name), "--vx-size",
              "0.002"])
    capsys.readouterr()
    a, b = (tmp_path / n / "all_super_cluster_info_nsub_2.npy"
            for n in ("jax", "port"))
    assert a.read_bytes() == b.read_bytes()
    info = np.load(b, allow_pickle=True)
    assert len(info) == 2 and info[0]["aabb"].shape == (2, 2, 3)


def test_depth_project_and_count_match_jax(tmp_path, capsys):
    """`depth-project` writes a byte-equal tree and `depth-count` counts
    the same, on two blobs seen by two cameras."""
    rng = np.random.RandomState(0)
    blob_a = rng.randn(400, 3) * 0.02 + np.array([0, 0.5, 0])
    blob_b = rng.randn(400, 3) * 0.02 + np.array([0.8, 0.5, 0.0])
    info = np.array([{
        "aabb": np.stack([np.stack([b.min(0), b.max(0)])
                          for b in (blob_a, blob_b)]),
        "pcd": {0: blob_a, 1: blob_b}}], dtype=object)
    frames = [{"file_path": f"images/frame_{i}.png",
               "transform_matrix": np.concatenate(
                   [look_at_camera(eye), [[0, 0, 0, 1]]]).tolist()}
              for i, eye in enumerate([[0, -3.0, 0], [0.5, -3.0, 0.3]])]
    results = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        pcd = tmp_path / name / "pcd"
        pcd.mkdir(parents=True)
        np.save(pcd / "all_super_cluster_info_nsub_2.npy", info,
                allow_pickle=True)
        write_ply(pcd / "density.ply",
                  np.concatenate([blob_a, blob_b]).astype(np.float32))
        (pcd / "transforms_train.json").write_text(json.dumps(
            {"frames": frames}))
        out = tmp_path / name / "depth"
        main(["depth-project", "--pcd-dir", str(pcd), "--transforms",
              str(pcd / "transforms_train.json"), "--output-dir", str(out),
              "--height", "240", "--width", "320", "--fx", "300", "--fy",
              "300", "--cx", "160", "--cy", "120"])
        capsys.readouterr()
        for cam_dir in (out / "super_cluster_0").glob("cam_*"):
            # the ground truth: each blob its own instance
            shutil.copy(cam_dir / "visible_label.png",
                        cam_dir / "label_gt.png")
        main(["depth-count", "--projection-dir", str(out), "--pcd-dir",
              str(pcd), "--frame-sampling-interval", "1"])
        results[name] = _json_out(capsys)
    assert results["port"] == results["jax"]
    assert results["port"]["total_count"] == 2
    jax_files = _files(tmp_path / "jax" / "depth")
    assert _files(tmp_path / "port" / "depth") == jax_files
    assert len(jax_files) == 2 * (2 + 2 + 1)   # occ_free_i, visible*, label


def test_native_build_matches_the_jax_backend(tmp_path, monkeypatch):
    """The port's library, built on this CPU into a temporary directory
    from the copied source, gives the JAX backend's points and labels."""
    lib = nat.build(tmp_path)
    assert lib.parent == tmp_path and lib.name.startswith(
        "libpointcloud_ops-")
    assert nat.build(tmp_path) == lib          # built once
    monkeypatch.setattr(nat, "_lib", nat.open_library(lib))
    assert jnat.available()
    pts = blobs([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0.1]], n=400, seed=5)
    pts = np.concatenate([pts, np.random.default_rng(6).uniform(
        -1, 1, (30, 3)).astype(np.float32)])
    np.testing.assert_array_equal(nat.voxel_downsample(pts, 0.004),
                                  jnat.voxel_downsample(pts, 0.004))
    labels = nat.dbscan(pts, 0.03, 10)
    np.testing.assert_array_equal(labels, jnat.dbscan(pts, 0.03, 10))
    assert set(labels.tolist()) == {-1, 0, 1, 2}
    np.testing.assert_array_equal(nat.statistical_outlier_removal(pts),
                                  jnat.statistical_outlier_removal(pts))
    for k in (2, 3, 5):
        np.testing.assert_array_equal(nat.kmeans(pts, k, seed=1),
                                      jnat.kmeans(pts, k, seed=1))


def test_native_build_without_openmp_gives_the_same_results(tmp_path):
    """A compiler that cannot link OpenMP builds the ops single-threaded
    (the Makefile's probe then sets OPENMP to a warning switch); their
    outputs equal the OpenMP build's."""
    import subprocess
    lib = tmp_path / "libpointcloud_ops_serial.so"
    subprocess.run(["make", "-s", "-C", str(nat._DIR), f"LIB={lib}",
                    "OPENMP=-Wno-unknown-pragmas"], check=True,
                   capture_output=True, timeout=300)
    serial = nat.open_library(lib)
    threaded = nat.open_library(nat.build(tmp_path))
    pts = blobs([[0, 0, 0], [0.3, 0, 0], [0, 0.3, 0.1]], n=400, seed=7)
    outs = []
    for lib_ in (serial, threaded):
        keep = np.empty(len(pts), np.uint8)
        lib_.statistical_outlier_removal(pts, len(pts), 20, 2.0, keep)
        labels = np.zeros(len(pts), np.int32)
        lib_.kmeans(pts, len(pts), 3, 50, 1, labels)
        dbl = np.empty(len(pts), np.int32)
        lib_.dbscan(pts, len(pts), 0.03, 10, dbl)
        outs.append((keep, labels, dbl))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    flags = subprocess.run(["make", "-s", "-C", str(nat._DIR), "flags",
                            "CXX=no-such-compiler"], capture_output=True,
                           text=True, check=True).stdout
    assert "-fopenmp" not in flags and "-Wno-unknown-pragmas" in flags


def test_native_build_failure_keeps_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "native"
    shutil.copytree(nat._DIR, src, ignore=shutil.ignore_patterns(
        "__pycache__", "*.py"))
    (src / "src" / "pointcloud_ops.cc").write_text("int broken(\n")
    monkeypatch.setattr(nat, "_DIR", src)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "_build")
    for name, value in (("_lib", None), ("_tried", False), ("_error", None)):
        monkeypatch.setattr(nat, name, value)
    assert not nat.available()
    assert "native build failed" in nat.load_error()
    assert "pointcloud_ops.cc" in nat.load_error()
    assert not list((tmp_path / "_build").glob("*.so"))
