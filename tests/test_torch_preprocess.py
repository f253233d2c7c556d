"""The port's preprocessing commands against the JAX CLI's, byte for byte
on the same inputs made from numpy seeds: `process-labels`, `rescale`,
`segment-masks` (with a colour prior, and priorless through the native
KMeans, each with its transforms.json update) and `import-colmap` (a text
model of ring cameras)."""
from __future__ import annotations

import json

import numpy as np
import pytest
from PIL import Image

from cropnerf_tpu import cli as jcli
from cropnerf_tpu_torch import cli
from test_colmap import write_text_model

MAINS = (("jax", jcli.main), ("port", cli.main))


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _blob_images(root, n=3, size=(40, 48), seed=0):
    """Orange discs and a green disc on a grey ground: RGB frames, and
    instance-colour images of the discs on black."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:size[0], :size[1]]
    (root / "images").mkdir(parents=True)
    (root / "seg").mkdir()
    for i in range(n):
        img = np.full(size + (3,), 128, np.uint8)
        img += rng.integers(0, 6, img.shape, dtype=np.uint8)
        seg = np.zeros(size + (3,), np.uint8)
        for k, colour in enumerate([(230, 120, 20), (220, 110, 30),
                                    (40, 180, 60)]):
            cy, cx = rng.integers(8, size[0] - 8), rng.integers(8,
                                                                size[1] - 8)
            disc = (ys - cy) ** 2 + (xs - cx) ** 2 <= rng.integers(9, 30)
            img[disc] = colour
            seg[disc] = ((k + 1) * 70, 255 - k * 60, 40 * k)
        Image.fromarray(img).save(root / "images" / f"frame_{i:04d}.png")
        Image.fromarray(seg).save(root / "seg" / f"frame_{i:04d}.png")
    frames = [{"file_path": f"images/frame_{i:04d}.png"} for i in range(n)]
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))


def _run_both(tmp_path, capsys, make_inputs, argv):
    """Each CLI on its own copy of the inputs; returns both output trees
    and both last printed lines."""
    outs, printed = {}, {}
    for name, main in MAINS:
        root = tmp_path / name
        root.mkdir()
        make_inputs(root)
        main([a.format(root=root) for a in argv])
        printed[name] = capsys.readouterr().out.strip().splitlines()[-1]
        outs[name] = _files(root)
    return outs, printed


def test_process_labels_matches_jax(tmp_path, capsys):
    outs, printed = _run_both(
        tmp_path, capsys, _blob_images,
        ["process-labels", "--seg-dir", "{root}/seg", "--out-dir",
         "{root}/labels"])
    assert outs["port"] == outs["jax"]
    assert printed["port"] == printed["jax"] == "converted 3 images"
    label = np.asarray(Image.open(tmp_path / "port" / "labels" /
                                  "label_frame_0000.png"))
    assert set(np.unique(label)) <= {0, 1, 2, 3} and label.max() > 0


@pytest.mark.parametrize("nearest", [True, False])
def test_rescale_matches_jax(tmp_path, capsys, nearest):
    argv = ["rescale", "--src-dir", "{root}/images", "--dst-dir",
            "{root}/half", "--factor", "2"] + (["--nearest"] if nearest
                                               else [])
    outs, printed = _run_both(tmp_path, capsys, _blob_images, argv)
    assert outs["port"] == outs["jax"]
    assert json.loads(printed["port"])["rescaled"] == 3
    assert Image.open(tmp_path / "port" / "half" /
                      "frame_0000.png").size == (24, 20)


@pytest.mark.parametrize("prior", [["--color", "230,120,20", "--k", "1"],
                                   ["--k", "3"]])
def test_segment_masks_matches_jax(tmp_path, capsys, prior):
    argv = ["segment-masks", "--image-dir", "{root}/images", "--out-dir",
            "{root}/masks", "--update-transforms",
            "{root}/transforms.json"] + prior
    outs, printed = _run_both(tmp_path, capsys, _blob_images, argv)
    assert outs["port"] == outs["jax"]
    assert json.loads(printed["port"])["segmented"] == 3
    mask = np.asarray(Image.open(tmp_path / "port" / "masks" /
                                 "mask_frame_0000.png"))
    assert 0 < (mask > 0).mean() < 0.2
    meta = json.loads((tmp_path / "port" / "transforms.json").read_text())
    assert meta["frames"][0]["semantic_path"] == "masks/mask_frame_0000.png"


def test_import_colmap_matches_jax(tmp_path, capsys):
    """A text model of eight cameras on a ring looking at the origin."""
    poses = []
    for i in range(8):
        theta = 2 * np.pi * i / 8
        eye = np.array([3 * np.cos(theta), 3 * np.sin(theta), 0.5])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])        # world → camera (OpenCV)
        poses.append((R, -R @ eye))

    def model(root):
        (root / "sparse").mkdir()
        write_text_model(root / "sparse", poses)

    outs, printed = _run_both(
        tmp_path, capsys, model,
        ["import-colmap", "--colmap-dir", "{root}/sparse", "--output",
         "{root}/transforms.json", "--semantic-rel-dir", "semantics",
         "--semantic-ext", ".png"])
    assert outs["port"] == outs["jax"]
    meta = json.loads((tmp_path / "port" / "transforms.json").read_text())
    assert len(meta["frames"]) == 8
    assert meta["frames"][0]["semantic_path"] == "semantics/frame_0000.png"
    assert printed["port"].endswith("(8 frames)")
