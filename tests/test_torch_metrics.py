"""The port's eval metrics (ops/metrics.py ssim and binary_iou, ops/lpips.py)
against the JAX package on seeded numpy images.  Tolerances: SSIM, PSNR
and IoU 1e-5 relative; LPIPS 1e-4 relative (float32 convolutions summed in
another order)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops import lpips as jlpips
from cropnerf_tpu.ops import metrics as jmetrics
from cropnerf_tpu_torch.ops import lpips as tlpips
from cropnerf_tpu_torch.ops import metrics as tmetrics

REL = 1e-5
LPIPS_REL = 1e-4


def _images(seed: int, h: int, w: int, c: int = 3):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, c), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.1, (h, w, c)), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(32, 32, 3), (24, 40, 3), (11, 11, 1)])
def test_ssim_and_psnr_match_jax(shape):
    a, b = _images(0, *shape)
    for x, y in ((a, b), (a, a), (b, np.zeros_like(b))):
        ref = float(jmetrics.ssim(jnp.array(x), jnp.array(y)))
        got = float(tmetrics.ssim(torch.from_numpy(x), torch.from_numpy(y)))
        assert got == pytest.approx(ref, rel=REL, abs=1e-6)
    ref = float(jmetrics.psnr(jnp.array(a), jnp.array(b)))
    got = float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(ref, rel=REL)


@pytest.mark.parametrize("threshold", [0.5, 0.9])
def test_binary_iou_matches_jax(threshold):
    rng = np.random.default_rng(1)
    p = rng.random((32, 32)).astype(np.float32)
    t = (rng.random((32, 32)) > 0.6).astype(np.float32)
    cases = [(p, t), (p, np.zeros_like(t)),
             # empty union: 1.0
             (np.zeros_like(p), np.zeros_like(t))]
    for x, y in cases:
        ref = float(jmetrics.binary_iou(jnp.array(x), jnp.array(y),
                                        threshold=threshold))
        got = float(tmetrics.binary_iou(torch.from_numpy(x),
                                        torch.from_numpy(y),
                                        threshold=threshold))
        assert got == pytest.approx(ref, rel=REL)
    assert float(tmetrics.binary_iou(torch.zeros(4, 4), torch.zeros(4, 4))) == 1.0


def test_uncalibrated_weights_are_the_jax_weights():
    ref = jlpips.uncalibrated_weights()
    got = tlpips.uncalibrated_weights()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)


@pytest.mark.parametrize("hw", [(32, 32), (36, 28)])
def test_lpips_uncalibrated_matches_jax(hw):
    a, b = _images(2, *hw)
    wj = jlpips.uncalibrated_weights()
    wt = tlpips.uncalibrated_weights()
    for x, y in ((a, b), (a, a)):
        ref = float(jlpips.lpips(jnp.array(x), jnp.array(y), wj))
        got = float(tlpips.lpips(torch.from_numpy(x), torch.from_numpy(y), wt))
        assert got == pytest.approx(ref, rel=LPIPS_REL, abs=1e-7)


def test_lpips_weight_file_and_env_var_match_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    w = {"conv0_w": rng.randn(3, 3, 3, 8).astype(np.float32) * 0.3,
         "conv0_b": rng.randn(8).astype(np.float32) * 0.1,
         "lin0": np.abs(rng.randn(8)).astype(np.float32),
         "conv1_w": rng.randn(3, 3, 8, 8).astype(np.float32) * 0.3,
         "conv1_b": np.zeros(8, np.float32),
         "conv2_w": rng.randn(3, 3, 8, 6).astype(np.float32) * 0.3,
         "conv2_b": np.zeros(6, np.float32),
         "lin2": np.abs(rng.randn(6)).astype(np.float32)}
    path = tmp_path / "w.npz"
    np.savez(path, **w)
    assert tlpips.load_weights(tmp_path / "missing.npz") is None
    a, b = _images(3, 20, 20)
    for value in (str(path), "uncalibrated"):
        monkeypatch.setenv("CROPNERF_LPIPS_WEIGHTS", value)
        jlpips.reset_weights_cache()
        tlpips.reset_weights_cache()
        try:
            assert tlpips.lpips_available()
            ref = float(jlpips.lpips(jnp.array(a), jnp.array(b)))
            got = float(tlpips.lpips(torch.from_numpy(a), torch.from_numpy(b)))
        finally:
            jlpips.reset_weights_cache()
            tlpips.reset_weights_cache()
        assert got == pytest.approx(ref, rel=LPIPS_REL)
    monkeypatch.delenv("CROPNERF_LPIPS_WEIGHTS")
    assert not tlpips.lpips_available()
    assert tlpips.lpips(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3)) is None
    tlpips.reset_weights_cache()
