"""The port's viewer (cropnerf_tpu_torch/viewer/server.py) on the CPU:
``make_model_renderer`` against the JAX package's on the same converted
parameters of cropnerf-tiny (float32 arm, 16x16, one 256-ray chunk) for
the rgb (through the uncertainty filter at 0.5), depth, uncertainty and
instances channels, and ``ViewerServer`` over HTTP on a free port.

Tolerance: 1e-4 (tests/torch_parity.py's float32 arm) on every channel.
A depth image is the median sample's depth over its largest value, so a
ray whose median sample lands on the other side of a bin edge moves by a
bin: depth is held to 1e-4 on all but 1 % of the pixels.
"""
from __future__ import annotations

import dataclasses
import io
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
from cropnerf_tpu.viewer import server as jserver
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.viewer import server
from test_torch_ddp import params_pair

SIZE = 16
LOD = 4
N_SAMPLES = 32
TOL = 1e-4
DEPTH_SHARE = 0.01
VIEW = dict(theta=0.7, phi=0.3, radius=1.1)


def _cfg(presets):
    return dataclasses.replace(presets["cropnerf-tiny"],
                               eval_num_rays_per_chunk=SIZE * SIZE)


def _grid():
    """A Hessian grid whose pointwise uncertainty spans the filter value."""
    rng = np.random.default_rng(0)
    cells = (2 ** LOD + 1) ** 3
    return (N_SAMPLES * 10.0 ** rng.uniform(-5, 3, cells)).astype(np.float32)


def _overlays():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.4, 0.4, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    boxes = np.array([[[-0.3, -0.3, -0.2], [0.1, 0.2, 0.3]]], np.float32)
    return (pts, cols), boxes


@pytest.fixture(scope="module")
def renderers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CROPNERF_FP32_MATMUL", "1")
        jax.clear_caches()
        jcfg = _cfg(JAX_PRESETS)
        jp, tp = params_pair("cropnerf-tiny", 1)
        instances, aabbs = _overlays()
        kw = dict(size=SIZE, hessian=_grid(), uncertainty_lod=LOD,
                  uncertainty_n_samples=N_SAMPLES, instances=instances,
                  aabbs=aabbs)
        ref = jserver.make_model_renderer(jp, jcfg, **kw)
        got = server.make_model_renderer(tp, _cfg(PRESETS),
                                         compute_dtype=torch.float32, **kw)
        yield ref, got
    jax.clear_caches()


@pytest.mark.parametrize("channel,unc_filter", [
    ("rgb", 0.5), ("rgb", 1.0), ("depth", 1.0), ("uncertainty", 1.0),
    ("instances", 1.0)])
def test_renderer_matches_jax(renderers, channel, unc_filter):
    ref_fn, got_fn = renderers
    ref = np.asarray(ref_fn(**VIEW, channel=channel, unc_filter=unc_filter))
    got = got_fn(**VIEW, channel=channel, unc_filter=unc_filter)
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)
    if channel == "depth":
        assert (diff > TOL).mean() <= DEPTH_SHARE, (diff > TOL).mean()
    else:
        assert diff.max() <= TOL, (channel, diff.max())
    assert got.std() > 0, channel


def test_filter_changes_the_render(renderers):
    _, got_fn = renderers
    a = got_fn(**VIEW, channel="accumulation", unc_filter=0.5)
    b = got_fn(**VIEW, channel="accumulation", unc_filter=1.0)
    assert not np.allclose(a, b)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_server_serves_the_page_and_pngs(renderers):
    _, got_fn = renderers
    srv = server.ViewerServer(got_fn, host="127.0.0.1", port=0)
    srv.start_background()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        status, kind, body = _get(base + "/")
        assert status == 200 and kind == "text/html"
        assert b"cropnerf viewer" in body
        for channel in ("rgb", "depth", "uncertainty", "instances"):
            status, kind, body = _get(
                f"{base}/render?theta=0.2&phi=0.3&r=1.2&f=0.8"
                f"&channel={channel}")
            assert status == 200 and kind == "image/png", channel
            img = Image.open(io.BytesIO(body))
            assert img.size == (SIZE, SIZE) and img.mode == "RGB"
        assert _get(base + "/nothing")[0] == 404
    finally:
        srv.shutdown()
