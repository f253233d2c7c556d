"""The fused PE proposal nets (K5, ``fused_pe_mlp``), the transmittance
scan (K6, ``render_weights_cuda``) and the depth point-cloud export of the
PyTorch port against the JAX package.

The path is ``cropnerf-mxu`` with both PE proposal nets on the fused
kernel (``mlp_impl="pallas-fused"``, as ``benchmarks/ab_pe_fused.py``
builds it), here at full widths with few samples per ray.  The JAX
kernels run as their own tests run them on the CPU (interpret mode on
128-row tiles, or the jnp path); the port's wrappers take their plain
PyTorch versions for CPU tensors.  Each comparison runs in the float32 arm
(1e-4) and the bf16 arm (2e-2; gradients 5e-2, the rtol of JAX's own
kernel-vs-fallback test).  CPU models of the CUDA kernels' loops hold the
kernels' arithmetic (the encoding's backward through the selector, the
segmented warp scan) against the plain versions.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas import fused_pe_field as jfield
from cropnerf_tpu.ops.pallas.transmittance import render_weights_pallas
from cropnerf_tpu_torch.ops import render as trender
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
from cropnerf_tpu_torch.ops.cuda.transmittance import render_weights_cuda
from torch_parity import (arm, assert_close, np_wbs, to_jax,  # noqa: F401
                          to_torch)

BWD_TOL = {"f32": 1e-4, "bf16": 5e-2}
PROP_WIDTHS = {5: [33, 64, 64, 1], 6: [39, 64, 64, 1]}   # the path's two nets


def _loss(out, lib):
    return lib.sum(lib.sin(out * 2.0))


# --- K5: fused_pe_mlp --------------------------------------------------------

# (num_freqs, N, JAX interpret): both nets through the Pallas kernel in
# interpret mode (128-row tiles) and through the jnp path, and a ragged N
# (the jnp path: no tile of 128 rows or more divides it)
K5_CASES = {"net0-kernel": (5, 256, True), "net1-kernel": (6, 256, True),
            "net0-jnp": (5, 256, False), "net1-ragged": (6, 200, False)}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_fused_pe_mlp_matches_jax(case, arm):
    F, n, interpret = K5_CASES[case]
    rng = np.random.default_rng(20 + F)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wbs = np_wbs(rng, PROP_WIDTHS[F])
    s = jnp.asarray(jfield.pe_selector_matrix(F))

    def jloss(x, wbs):
        out = jfield.fused_pe_mlp(x, s, wbs, F, 128, interpret, 3, 128)
        return _loss(out, jnp), out

    (_, ref), (jdx, jdw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), to_jax(wbs))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [w.requires_grad_(True) for w in to_torch(wbs)]
    before = (tfield.fused_pe_mlp.launches, tfield.fused_pe_mlp_bwd.launches)
    out = tfield.fused_pe_mlp(xt, wt, F, arm.dtype)
    _loss(out, torch).backward()
    assert before == (tfield.fused_pe_mlp.launches,
                      tfield.fused_pe_mlp_bwd.launches)   # the CPU: no launch
    assert_close(out, ref, arm.tol, "out")
    tol = BWD_TOL[arm.name]
    assert_close(xt.grad, jdx, tol, "dx")
    for i, (w, r) in enumerate(zip(wt, jdw)):
        assert_close(w.grad, r, tol, f"wbs {i}")


def test_fused_pe_mlp_checks_its_inputs():
    wbs = to_torch(np_wbs(np.random.default_rng(0), PROP_WIDTHS[5]))
    x = torch.rand(10, 3)
    with pytest.raises(ValueError):                 # encoding width 33, not 39
        tfield.fused_pe_mlp(x, wbs, 6)
    with pytest.raises(ValueError):                 # not float32
        tfield.fused_pe_mlp(x.double(), wbs, 5)
    with pytest.raises(ValueError):                 # an odd weight list
        tfield.fused_pe_mlp(x, wbs[:3], 5)
    assert tfield.fused_pe_mlp(x[:0], wbs, 5).shape == (0, 1)
    tfield._check_pe_mlp_bwd(x, wbs, 5)             # the backward kernel's nets
    wide = to_torch(np_wbs(np.random.default_rng(0), [33, 128, 128, 1]))
    with pytest.raises(ValueError, match="hidden widths"):
        tfield._check_pe_mlp_bwd(x, wide, 5)


def _pe_encoding(x, F):
    """The kernels' encoding columns [x | sin(2^f x) | cos(2^f x)] in
    f-major blocks: (encoding, each column's coordinate, its frequency,
    its pre-activation, the first cos column)."""
    dim = x.shape[1]
    din, sin_end = dim * (1 + 2 * F), dim * (1 + F)
    col = torch.arange(din)
    j = torch.where(col < sin_end, col - dim, col - sin_end)
    coord = torch.where(col < dim, col, j % dim)
    freq = torch.where(col < dim, torch.ones(din),
                       (2.0 ** (j // dim)).float())
    pre = x[:, coord] * freq
    enc = torch.where(col < dim, x[:, coord],
                      torch.where(col < sin_end, torch.sin(pre),
                                  torch.cos(pre)))
    return enc, coord, freq, pre, sin_end


def _wmma_forward_model(x, wbs, F):
    """The forward of the "wmma" route (csrc/fused_mlp.cu's PE variant) in
    torch, on the buffers pack_mlp builds: the encoding zero-padded to a
    multiple of 16 columns and rounded to bf16, each layer's product on
    the packed bf16 weights with f32 sums plus the f32 bias, relu and bf16
    for the hidden layers, the last layer's first Dout columns."""
    dim = x.shape[1]
    wbuf, bbuf, meta = tmlp.pack_mlp(dim * (1 + 2 * F), wbs)
    din, din_pad, dout, n_layers, _ = meta[:5]
    layers = [meta[5 + 5 * i:10 + 5 * i] for i in range(n_layers)]
    a = torch.zeros((x.shape[0], din_pad))
    a[:, :din] = _pe_encoding(x, F)[0]
    h = a.bfloat16()
    for l, (w_off, b_off, k, n, _) in enumerate(layers):
        h = (h.float() @ wbuf[w_off:w_off + k * n].reshape(k, n).float()
             + bbuf[b_off:b_off + n])
        if l < n_layers - 1:
            h = torch.relu(h).bfloat16()
    return h[:, :dout]


@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("F", [5, 6])
def test_wmma_route_model_reproduces_plain(F, hidden):
    """The wmma route's forward on pack_mlp's buffers against the plain
    version: the 64-wide nets of the path and cropnerf-mxu-q's 128-wide
    ones, which take this route on the card; 300 rows."""
    rng = np.random.default_rng(50 + F)
    dims = [3 * (1 + 2 * F), hidden, hidden, 1]
    wt = to_torch(np_wbs(rng, dims))
    x = torch.from_numpy(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    if hidden == 128:
        assert tfield.pe_mlp_fwd_route(3, F, dims[1:]) == "wmma"
    with torch.no_grad():
        got = _wmma_forward_model(x, wt, F)
        plain = tfield.fused_pe_mlp_plain(x, wt, F)
    assert got.shape == (300, 1)
    assert_close(got, plain, 1e-5, "out")


def _kernel_model_pe_mlp(x, wbs, F, g, sm_count):
    """The PE MLP's CUDA kernels in torch, on the weight images
    ``pe_mlp_images`` builds, read back as their wgmma operands index them:
    the forward (csrc/fused_pe_mlp_fwd.cu: the encoding rounded to bf16,
    every layer's product on the forward images with f32 sums, bias, relu
    and bf16 for the hidden layers, the last bias in f32) and the backward
    (csrc/fused_pe_mlp_bwd.cu), in its order: the encoding from x with its
    f32 derivatives; the bf16 recompute; per 64-row tile, going back
    through the layers, the weight gradient Aᵀ·G of bf16 operands added
    into its warpgroup's f32 sum, the input gradient G·Wᵀ, the relu mask of
    the bf16 activation and the f32 column sums; then each block's
    warpgroups' sums in order and the blocks' in order; dx from layer 0's
    f32 input gradient times d(encode)/d(pre)·2^f, summed per coordinate in
    column order.  Returns (out, dx, [dW0, db0, ...])."""
    N, dim = x.shape
    din, dout, n_layers = dim * (1 + 2 * F), wbs[-2].shape[1], len(wbs) // 2
    enc, coord, freq, pre, sin_end = _pe_encoding(x, F)
    col = torch.arange(din)
    HW, OW = tfield.PE_MLP_HIDDEN, tfield.PE_MLP_OUT
    widths = [HW] * (n_layers - 1) + [OW]
    img, bias = tfield.pe_mlp_images(wbs)
    total_w = sum(HW * n for n in widths)
    k_, n_ = torch.arange(HW)[:, None], None
    fw, bw, boff = [], [], 0
    for l, n in enumerate(widths):
        off = l * HW * HW
        n_ = torch.arange(n)[None]
        fw.append(img[off + (k_ // 8) * n * 8 + n_ * 8 + k_ % 8].float())
        jj, ii = torch.arange(n)[:, None], torch.arange(HW)[None]
        bw.append(img[total_w + off + (jj // 8) * HW * 8 + ii * 8
                      + jj % 8].float())
    b_at = [l * HW for l in range(n_layers)]
    # the forward, and the backward's recompute: the same products
    e = torch.zeros((N, HW))
    e[:, :din] = enc
    acts = [e.bfloat16()]
    for l in range(n_layers - 1):
        acts.append(torch.relu(acts[l].float() @ fw[l]
                               + bias[b_at[l]:b_at[l] + HW]).bfloat16())
    out = (acts[-1].float() @ fw[-1] + bias[b_at[-1]:b_at[-1] + OW])[:, :dout]
    gl = torch.zeros((N, OW))
    gl[:, :dout] = g
    deriv = torch.where(col < dim, torch.ones(din),
                        torch.where(col < sin_end, torch.cos(pre),
                                    -torch.sin(pre)) * freq)
    blocks = tfield.pe_mlp_blocks(N, sm_count, tfield.PE_MLP_WGS)
    wgs = blocks * tfield.PE_MLP_WGS
    dws = [[torch.zeros((HW, n)) for n in widths] for _ in range(wgs)]
    dbs = [[torch.zeros(n) for n in widths] for _ in range(wgs)]
    dx = torch.zeros((N, dim))
    for t in range(-(-N // 64)):
        r = slice(64 * t, min(64 * t + 64, N))
        wg = t % wgs
        gcur = gl[r].bfloat16()
        dbs[wg][-1] += gl[r].sum(0)
        for l in range(n_layers - 1, -1, -1):
            dws[wg][l] += acts[l][r].float().T @ gcur.float()
            v = gcur.float() @ bw[l]
            if l == 0:
                break
            v = torch.where(acts[l][r].float() > 0, v, 0.0)
            dbs[wg][l - 1] += v.sum(0)
            gcur = v.bfloat16()
        d_pre = v[:, :din] * deriv[r]
        for c in range(din):                      # column order, per coordinate
            dx[r, coord[c]] += d_pre[:, c]
    grads = []
    for l in range(n_layers):
        w, b = wbs[2 * l], wbs[2 * l + 1]
        parts = [sum(dws[wg][l] for wg in range(
            blk * tfield.PE_MLP_WGS, (blk + 1) * tfield.PE_MLP_WGS))
            for blk in range(blocks)]
        bparts = [sum(dbs[wg][l] for wg in range(
            blk * tfield.PE_MLP_WGS, (blk + 1) * tfield.PE_MLP_WGS))
            for blk in range(blocks)]
        grads += [sum(parts)[:w.shape[0], :w.shape[1]],
                  sum(bparts)[:b.numel()].reshape(b.shape)]
    return out, dx, grads


@pytest.mark.parametrize("F", [5, 6])
def test_pe_mlp_kernel_model_reproduces_plain(F):
    """The CUDA kernels' model against the JAX VJP of fused_pe_mlp (its
    kernel in interpret mode at 384 rows; at 300 rows, no tile divisor, its
    jnp path) and the forward against the plain version; the rows spread
    over 2 blocks of 3 warpgroups, at 300 rows the last tile ragged."""
    n = {5: 384, 6: 300}[F]
    rng = np.random.default_rng(30 + F)
    xn = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wn = np_wbs(rng, PROP_WIDTHS[F])
    cot = rng.standard_normal((n, 1)).astype(np.float32)
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    ref_out, vjp = jax.vjp(lambda x, w: jfield.fused_pe_mlp(
        x, s, w, F, 128, True, 3, 128), jnp.asarray(xn), to_jax(wn))
    jdx, jdw = vjp(jnp.asarray(cot))
    x, wt = torch.from_numpy(xn), to_torch(wn)
    with torch.no_grad():
        got_out, dx, grads = _kernel_model_pe_mlp(x, wt, F,
                                                  torch.from_numpy(cot), 2)
        plain = tfield.fused_pe_mlp_plain(x, wt, F)
    assert tfield.pe_mlp_blocks(n, 2, tfield.PE_MLP_WGS) == 2
    assert tfield.pe_mlp_blocks(n, 132, tfield.PE_MLP_WGS) == 2
    assert_close(got_out, plain, 1e-5, "out")
    assert_close(got_out, ref_out, 2e-2, "out vs JAX")
    for i, (g, r) in enumerate(zip([dx] + grads, [jdx, *jdw])):
        r = np.asarray(r)
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = (np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-6))
        assert err <= 2e-2, (i, err)


def test_pe_mlp_images_lay_out_both_operands():
    """Every weight of the backward's images once in the forward image at
    (k/8)·width·8 + n·8 + k%8 and once in the input-gradient image at
    (n/8)·64·8 + k·8 + n%8, zero elsewhere; the biases padded alike."""
    wt = to_torch(np_wbs(np.random.default_rng(3), PROP_WIDTHS[6]))
    img, bias = tfield.pe_mlp_images(wt)
    assert img.dtype == torch.bfloat16 and img.numel() == 2 * (2 * 64 * 64
                                                               + 64 * 16)
    assert bias.tolist() == torch.cat([
        torch.nn.functional.pad(wt[2 * l + 1].reshape(-1), (0, n - w))
        for l, (w, n) in enumerate([(64, 64), (64, 64), (1, 16)])]).tolist()
    half = img.numel() // 2
    for l, (k, n, width) in enumerate([(39, 64, 64), (64, 64, 64),
                                       (64, 1, 16)]):
        w = wt[2 * l].bfloat16()
        kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n),
                                indexing="ij")
        off = l * 64 * 64
        fwd = img[off + (kk // 8) * width * 8 + nn * 8 + kk % 8]
        bwd = img[half + off + (nn // 8) * 64 * 8 + kk * 8 + nn % 8]
        assert torch.equal(fwd, w) and torch.equal(bwd, w)
        block = img[off:off + 64 * width]
        assert torch.count_nonzero(block) == torch.count_nonzero(w)


@pytest.mark.parametrize("preset", ["cropnerf-mxu", "cropnerf-mxu-q",
                                    "cropnerf-mxu-big", "cropnerf-mxu-huge"])
def test_pe_mlp_forward_route_by_preset(preset):
    """Every preset's PE proposal nets at 64 wide take the wgmma forward
    kernel (csrc/fused_pe_mlp_fwd.cu), cropnerf-mxu-q's 128-wide nets the
    wmma route (the PE variant of csrc/fused_mlp.cu): the route depends on
    the net's shape alone."""
    from cropnerf_tpu_torch.models.config import PRESETS
    from cropnerf_tpu_torch.models.proposal import proposal_init
    want = "wmma" if preset == "cropnerf-mxu-q" else "wgmma"
    for i, p in enumerate(PRESETS[preset].model.proposal_fields):
        prop = proposal_init(p, torch.Generator().manual_seed(i), "cpu")
        widths = [w.shape[1] for w in prop.mlp.w]
        assert tfield.pe_mlp_fwd_route(3, p.pe_freqs, widths) == want
        assert tfield.pe_mlp_kernels_take(3, p.pe_freqs, widths) == (
            want == "wgmma")


# (dim, F, output widths, route): the wgmma kernels' edges
ROUTE_EDGES = [(3, 8, [64, 64, 1], "wgmma"),      # 51 encoding columns
               (3, 10, [64, 64, 1], "wgmma"),     # 63 columns
               (3, 11, [64, 64, 1], "wmma"),      # 69 columns
               (3, 5, [32, 1], "wgmma"),          # 2 layers, narrower
               (3, 5, [64, 64, 64, 1], "wmma"),   # 4 layers
               (3, 5, [64, 64, 17], "wmma"),      # 17 outputs
               (3, 5, [64, 65, 1], "wmma"),       # a hidden layer of 65
               (2, 5, [64, 64, 1], "wmma")]       # x [N, 2]


@pytest.mark.parametrize("case", range(len(ROUTE_EDGES)))
def test_pe_mlp_forward_route_edges(case):
    dim, F, widths, route = ROUTE_EDGES[case]
    assert tfield.pe_mlp_fwd_route(dim, F, widths) == route


@pytest.mark.parametrize("n", [1_048_576, 393_216, 1_048_576 - 77, 200, 50,
                               1])
@pytest.mark.parametrize("wgs", [tfield.PE_MLP_FWD_WGS, tfield.PE_MLP_WGS],
                         ids=["forward", "backward"])
def test_pe_mlp_tile_plan(n, wgs):
    """The wgmma kernels' persistent plan at the path's shapes (both nets
    of a training step), a ragged N and N < 64, on 132 SMs: every 64-row
    tile taken once, by warpgroup w of block b at wgs·b + w + k·wgs·blocks
    in order, every block with a tile, the warpgroups' runs within one
    tile of each other."""
    tiles = -(-n // 64)
    blocks = tfield.pe_mlp_blocks(n, 132, wgs)
    assert blocks == min(132, -(-tiles // wgs))
    # the kernels' loop: tile = wgs·b + w, then every wgs·blocks-th after it
    plan = [list(range(wgs * b + w, tiles, wgs * blocks))
            for b in range(blocks) for w in range(wgs)]
    assert sorted(t for run in plan for t in run) == list(range(tiles))
    assert all(plan[wgs * b] for b in range(blocks))
    lens = [len(run) for run in plan]
    assert max(lens) - min(lens) <= 1


def _stand_in_kernels(monkeypatch):
    """The K5 kernels' entry points stood in for by the plain version,
    recording what each was handed."""
    seen = {}

    def launch(x, wbs, num_freqs, img, bias):
        seen["fwd"] = (img, bias)
        return tfield.fused_pe_mlp_plain(x, wbs, num_freqs)

    def wide(x, wbs, num_freqs):
        seen["wide"] = True
        return tfield.fused_pe_mlp_plain(x, wbs, num_freqs)

    def bwd(x, wbs, num_freqs, g, need_dx, need_dw, images):
        seen["bwd"] = images
        return None, [torch.zeros_like(w) for w in wbs]

    monkeypatch.setattr(tfield, "_pe_mlp_fwd_launch", launch)
    monkeypatch.setattr(tfield, "fused_pe_mlp_wide", wide)
    monkeypatch.setattr(tfield, "fused_pe_mlp_bwd", bwd)
    return seen


def _hidden_net(hidden, seed=40):
    rng = np.random.default_rng(seed)
    wt = to_torch(np_wbs(rng, [33, hidden, hidden, 1]))
    x = torch.from_numpy(rng.uniform(-1, 1, (100, 3)).astype(np.float32))
    return x, wt


@pytest.mark.parametrize("hidden", [64, 128])
def test_forward_saves_its_images_for_the_backward(hidden, monkeypatch):
    """Where a graph is recorded, the card path builds the wgmma kernels'
    weight images once, in the forward, and hands those very tensors to
    the backward: they equal pe_mlp_images of the weights.  A net on the
    wmma route has no backward kernel and records no graph.  The kernels
    are stood in for by the plain version here."""
    F = 5
    x, wt = _hidden_net(hidden)
    wt = [w.requires_grad_(True) for w in wt]
    seen = _stand_in_kernels(monkeypatch)
    if hidden == 128:
        with pytest.raises(ValueError, match="hidden widths"):
            tfield._fused_pe_mlp_card(x, wt, F)
        assert seen == {}
        return
    out = tfield._fused_pe_mlp_card(x, wt, F)
    out.sum().backward()
    img, bias = tfield.pe_mlp_images([w.detach() for w in wt])
    assert all(a is b for a, b in zip(seen["bwd"], seen["fwd"]))
    assert torch.equal(seen["fwd"][0], img)
    assert torch.equal(seen["fwd"][1], bias)


@pytest.mark.parametrize("hidden", [64, 128])
def test_forward_without_a_graph_builds_only_forward_images(hidden,
                                                            monkeypatch):
    """Where no graph is recorded (serving, the render, the depth cloud),
    the card path launches the forward kernel its route picks and builds
    no backward half: the wgmma kernel gets the forward images alone, the
    wmma route none."""
    F = 5
    x, wt = _hidden_net(hidden)
    seen = _stand_in_kernels(monkeypatch)
    with torch.no_grad():
        out = tfield._fused_pe_mlp_card(x, [w.requires_grad_(True)
                                            for w in wt], F)
    assert not out.requires_grad
    if hidden == 128:
        assert seen == {"wide": True}
        return
    img, bias = tfield.pe_mlp_images(wt)
    assert set(seen) == {"fwd"}
    assert torch.equal(seen["fwd"][0], img[:img.numel() // 2])
    assert torch.equal(seen["fwd"][1], bias)


def _images_by_layer(wbs):
    """pe_mlp_images written out layer by layer, as the kernels read them:
    the padded weight copied into each core-matrix layout."""
    n_layers = len(wbs) // 2
    fwd, bwd, bias = [], [], []
    for l in range(n_layers):
        w, b = wbs[2 * l], wbs[2 * l + 1].reshape(-1)
        width = tfield.PE_MLP_OUT if l == n_layers - 1 else 64
        wp = torch.zeros((64, width), dtype=torch.bfloat16)
        wp[:w.shape[0], :w.shape[1]] = w
        fwd.append(wp.reshape(8, 8, width).permute(0, 2, 1).reshape(-1))
        bwd.append(wp.reshape(64, width // 8, 8).permute(1, 0, 2).reshape(-1))
        bias.append(torch.nn.functional.pad(b, (0, width - b.numel())))
    return torch.cat(fwd), torch.cat(bwd), torch.cat(bias)


@pytest.mark.parametrize("widths", [PROP_WIDTHS[5], PROP_WIDTHS[6],
                                    [33, 32, 1], [39, 64, 48, 16]])
def test_pe_mlp_images_gather_equals_the_layer_layout(widths):
    """The images gathered at cached indices equal the layers laid out one
    by one, bit for bit, with and without the backward's half."""
    wt = to_torch(np_wbs(np.random.default_rng(41), widths))
    fwd, bwd, bias = _images_by_layer(wt)
    img, got_bias = tfield.pe_mlp_images(wt)
    assert torch.equal(img, torch.cat([fwd, bwd]))
    assert torch.equal(got_bias, bias)
    img, got_bias = tfield.pe_mlp_images(wt, backward=False)
    assert torch.equal(img, fwd) and torch.equal(got_bias, bias)


def test_proposal_density_pallas_fused_matches_jax(arm):
    """proposal_density of a PE net with mlp_impl="pallas-fused": density
    and the gradients of the weights and the positions."""
    from cropnerf_tpu.models.config import ProposalFieldConfig as JaxCfg
    from cropnerf_tpu.models.proposal import proposal_density as jax_density
    from cropnerf_tpu.models.proposal import proposal_init as jax_init
    from cropnerf_tpu_torch.models.config import ProposalFieldConfig
    from cropnerf_tpu_torch.models.proposal import (ProposalField,
                                                    proposal_density)
    from cropnerf_tpu_torch.ops.mlp import MLP
    kw = dict(field_type="pe", hidden_dim=64, num_layers=3, pe_freqs=5,
              mlp_impl="pallas-fused")
    params = jax_init(jax.random.PRNGKey(40), JaxCfg(**kw))
    pos = (np.random.default_rng(41).standard_normal((16, 24, 3)) * 0.8
           ).astype(np.float32)

    def jloss(p, x):
        d = jax_density(p, x, JaxCfg(**kw))
        return jnp.sum(jnp.sin(d)), d

    (_, ref), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(pos))
    mlp = MLP([torch.from_numpy(np.array(w)) for w in params["mlp"]["w"]],
              [torch.from_numpy(np.array(b)) for b in params["mlp"]["b"]])
    prop = ProposalField(mlp)
    xt = torch.from_numpy(pos).requires_grad_(True)
    d = proposal_density(prop, xt, ProposalFieldConfig(**kw),
                         compute_dtype=arm.dtype)
    torch.sum(torch.sin(d)).backward()
    assert_close(d, ref, arm.tol, "density")
    tol = BWD_TOL[arm.name]
    assert_close(xt.grad, jgx, tol, "positions")
    for i in range(3):
        assert_close(mlp.w[i].grad, jg["mlp"]["w"][i], tol, f"w{i}")
        assert_close(mlp.b[i].grad, jg["mlp"]["b"][i], tol, f"b{i}")


# --- K6: render_weights_cuda -------------------------------------------------

# (R, S, JAX tile): a [256, 48] block on four tiles, a ragged [7, 16] (the
# JAX jnp fallback) and the docstring's long axis, S = 3000
K6_CASES = {"256x48": (256, 48, 64), "ragged-7x16": (7, 16, 4),
            "8x3000": (8, 3000, 8)}


def _k6_inputs(R, S, seed=0):
    rng = np.random.default_rng(seed)
    density = (rng.uniform(0, 5, (R, S))).astype(np.float32)
    deltas = (rng.uniform(0, 0.1, (R, S)) * 48 / S).astype(np.float32)
    return density, deltas


@pytest.mark.parametrize("case", list(K6_CASES))
def test_render_weights_cuda_matches_jax_kernel(case):
    R, S, tile = K6_CASES[case]
    density, deltas = _k6_inputs(R, S)
    ref = render_weights_pallas(jnp.asarray(density), jnp.asarray(deltas),
                                tile_r=tile, interpret=True)
    before = render_weights_cuda.launches
    got = render_weights_cuda(torch.from_numpy(density),
                              torch.from_numpy(deltas))
    assert render_weights_cuda.launches == before
    assert got.dtype == torch.float32 and got.shape == (R, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_render_weights_cuda_casts_and_refuses_autograd():
    density, deltas = _k6_inputs(16, 48, seed=1)
    d64 = torch.from_numpy(density).double()
    got = render_weights_cuda(d64, torch.from_numpy(deltas))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), trender.render_weights(
        torch.from_numpy(density), torch.from_numpy(deltas)).numpy(),
        rtol=1e-6, atol=1e-7)
    leaf = torch.from_numpy(density).requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        render_weights_cuda(leaf, torch.from_numpy(deltas))
    with pytest.raises(ValueError, match="forward only"):
        render_weights_cuda(torch.from_numpy(density),
                            torch.from_numpy(deltas).requires_grad_(True))
    with torch.no_grad():              # no graph is recorded: no gradient
        render_weights_cuda(leaf, torch.from_numpy(deltas))
    with pytest.raises(ValueError):
        render_weights_cuda(torch.zeros(4, 8), torch.zeros(4, 9))


def _kernel_model_scan(density, deltas):
    """csrc/transmittance.cu's loop in torch: per row, 32-sample segments;
    in each a Hillis-Steele inclusive scan (the __shfl_up_sync steps) plus
    the running total of the earlier segments."""
    R, S = density.shape
    tau = density * deltas
    out = torch.empty_like(tau)
    carry = torch.zeros((R,))
    for s0 in range(0, S, 32):
        seg = torch.zeros((R, 32))
        w = min(32, S - s0)
        seg[:, :w] = tau[:, s0:s0 + w]
        incl = seg.clone()
        o = 1
        while o < 32:
            shifted = torch.zeros_like(incl)
            shifted[:, o:] = incl[:, :-o]
            incl = incl + shifted
            o *= 2
        accum = carry[:, None] + incl
        t = seg[:, :w]
        out[:, s0:s0 + w] = (1 - torch.exp(-t)) * torch.exp(-(accum[:, :w] - t))
        carry = carry + incl[:, 31]
    return out


@pytest.mark.parametrize("shape", [(5, 48), (3, 3000), (2, 33)])
def test_scan_kernel_model_reproduces_plain(shape):
    density, deltas = _k6_inputs(*shape, seed=2)
    d, dl = torch.from_numpy(density), torch.from_numpy(deltas)
    np.testing.assert_allclose(_kernel_model_scan(d, dl).numpy(),
                               trender.render_weights(d, dl).numpy(),
                               rtol=1e-5, atol=1e-6)


# --- the path: cropnerf-mxu with fused PE proposal nets ----------------------

def propfused(presets, **changes):
    """The path's configuration, reduced: ``cropnerf-mxu`` with both PE
    proposal nets on the fused kernel (``benchmarks/ab_pe_fused.py``'s
    ``dataclasses.replace``) at full widths, 32 and 16 proposal samples
    then 8 field samples per ray."""
    from torch_parity import reduced_mxu
    cfg = reduced_mxu(presets)
    m = cfg.model
    m = dataclasses.replace(
        m, proposal_fields=tuple(dataclasses.replace(p, mlp_impl="pallas-fused")
                              for p in m.proposal_fields))
    return dataclasses.replace(cfg, model=m, **changes)


def test_train_step_matches_jax(arm, monkeypatch):
    """One training step (every step updates the proposal nets, whose
    positions carry the camera-opt graph: K5's backward with dx)."""
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from test_torch_train import RAYS, STEP, check_train_step
    jcfg, tcfg = (propfused(p, train_num_rays_per_batch=RAYS)
                  for p in (JAX_PRESETS, TORCH_PRESETS))
    assert not tcfg.model.proposal_no_grad_schedule
    check_train_step(jcfg, tcfg, STEP, arm, monkeypatch)


def test_render_matches_jax(arm):
    """make_render_fn: an 8x8 image with lens distortion in one chunk."""
    from cropnerf_tpu.core.cameras import Cameras as JaxCameras
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu.train.step import make_render_fn as jax_make_render_fn
    from cropnerf_tpu_torch.core.cameras import Cameras as TorchCameras
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from cropnerf_tpu_torch.train.step import make_render_fn
    from test_torch_render_export import H, W, _camera_arrays
    from torch_parity import jax_and_torch_params
    jcfg, tcfg = (propfused(p, eval_num_rays_per_chunk=H * W)
                  for p in (JAX_PRESETS, TORCH_PRESETS))
    params, tp = jax_and_torch_params(jcfg.model, num_images=1)
    cams = _camera_arrays()
    ref = jax_make_render_fn(jcfg)(
        params, JaxCameras(**{k: jnp.asarray(v) for k, v in cams.items()}),
        0, H, W)
    got = make_render_fn(tcfg, compute_dtype=arm.dtype)(
        tp, TorchCameras(**{k: torch.from_numpy(v) for k, v in cams.items()}),
        0, H, W)
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap"):
        assert got[k].shape[:2] == (H, W)
        assert_close(got[k], ref[k], arm.tol, k)
    same_depth = np.isclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                            atol=arm.tol, rtol=arm.tol)
    assert same_depth.mean() >= (1.0 if arm.name == "f32" else 0.9)


# --- the depth point cloud ---------------------------------------------------

CLOUD_RAYS = 64


def _gap_threshold(values) -> float:
    """A threshold near the median that no value lies close to: the middle
    of the widest gap between neighbouring sorted values in the middle
    half, so that rounding between the two packages flips no decision."""
    v = np.sort(np.asarray(values, np.float64))
    lo, hi = len(v) // 4, 3 * len(v) // 4
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[i] + v[i + 1]) / 2)


def _jax_batch(jcfg, jb):
    """The per-batch body of the JAX ``generate_point_cloud`` (its
    ``run_batch``), from the package's public functions, returning the
    forward's outputs beside the points."""
    from cropnerf_tpu.core.cameras import generate_rays, near_far_collider
    from cropnerf_tpu.core.rays import RayBundle
    from cropnerf_tpu.data.databank import decode_pixel_index
    from cropnerf_tpu.models.model import forward
    m = jcfg.model

    @jax.jit
    def run(params, idx):
        cam, px, py = decode_pixel_index(idx, jb.height, jb.width)
        origins, dirs = generate_rays(jb.cameras, cam, px, py)
        n = idx.shape[0]
        rb = RayBundle(origins=origins, directions=dirs,
                       nears=jnp.zeros((n,)), fars=jnp.ones((n,)),
                       camera_idx=cam)
        rb = near_far_collider(rb, m.near_plane, m.far_plane)
        out = forward(params, rb, m, key=None, train=False)
        return out, origins + dirs * out["depth"]

    return run


def test_forward_and_depth_batch_match_jax(arm, monkeypatch):
    """The depth cloud's per-batch function on the ray indices of the JAX
    exporter's first batch (seed 0): the forward it runs (both fused
    proposal nets and the field), the points, colours and keep mask; in the
    float32 arm the JAX ``generate_point_cloud`` itself keeps the same
    points."""
    from cropnerf_tpu.export import pointcloud as jpc
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu_torch.export import pointcloud as tpc
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from test_torch_train import N_IMG, _banks
    from torch_parity import jax_and_torch_params
    jcfg, tcfg = propfused(JAX_PRESETS), propfused(TORCH_PRESETS)
    params, tp = jax_and_torch_params(jcfg.model, num_images=N_IMG)
    jb, tb = _banks()
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    jidx = jax.random.randint(sub, (CLOUD_RAYS,), 0, jb.num_pixels)
    ref, ref_pts = jax.tree_util.tree_map(np.asarray,
                                          _jax_batch(jcfg, jb)(params, jidx))
    acc_thr = _gap_threshold(ref["accumulation"][:, 0])
    sem_thr = _gap_threshold(ref["semantics_colormap"][:, 0])
    ref_keep = ((ref["accumulation"][:, 0] > acc_thr)
                & (ref["semantics_colormap"][:, 0] > sem_thr))
    assert 0 < ref_keep.sum() < CLOUD_RAYS

    seen = {}
    forward = tpc.forward

    def spy(*args, **kw):
        seen["out"] = forward(*args, **kw)
        return seen["out"]

    monkeypatch.setattr(tpc, "forward", spy)
    pts, rgb, keep = tpc.depth_points(
        tp, tcfg.model, tb, torch.from_numpy(np.array(jidx)).long(),
        semantic_threshold=sem_thr, accumulation_threshold=acc_thr,
        compute_dtype=arm.dtype)
    got = seen["out"]
    for k in ("rgb", "accumulation", "semantics", "semantics_colormap",
              "prop_depth_0", "prop_depth_1"):
        assert_close(got[k], ref[k], arm.tol, k)
    for i in range(3):
        assert_close(got["weights_list"][i], ref["weights_list"][i], arm.tol,
                     f"weights {i}")
    same_depth = np.isclose(got["depth"].numpy()[:, 0], ref["depth"][:, 0],
                            atol=arm.tol, rtol=arm.tol)
    assert same_depth.mean() >= (1.0 if arm.name == "f32" else 0.9)
    assert_close(pts[same_depth], ref_pts[same_depth], arm.tol, "points")
    assert_close(rgb, ref["rgb"], arm.tol, "colours")
    # a decision flips only where the reference lies within rounding of
    # its threshold; the gap thresholds leave none in either arm
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    if arm.name == "f32":
        j_pts, j_cols = jpc.generate_point_cloud(
            params, jcfg.model, jb, num_points=CLOUD_RAYS,
            rays_per_batch=CLOUD_RAYS, semantic_threshold=sem_thr,
            accumulation_threshold=acc_thr, remove_outliers=False,
            max_batches=1)
        assert_close(pts[keep], j_pts, 1e-4, "exported points")
        assert_close(rgb[keep], j_cols, 1e-4, "exported colours")


def _cloud(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * [1.0, 1.0, 0.05]
    pts[:12] *= 15.0                                   # far outliers
    return pts.astype(np.float32)


@pytest.mark.parametrize("std_ratio", [2.0, 10.0])
def test_outlier_removal_and_normals_match_jax(std_ratio):
    from cropnerf_tpu.counting.clustering import \
        statistical_outlier_removal as jax_sor
    from cropnerf_tpu.export.pointcloud import estimate_normals as jax_normals
    from cropnerf_tpu_torch.counting.clustering import \
        statistical_outlier_removal
    from cropnerf_tpu_torch.export.pointcloud import estimate_normals
    pts = _cloud()
    got, ref = statistical_outlier_removal(pts, 20, std_ratio), jax_sor(
        pts, 20, std_ratio)
    np.testing.assert_array_equal(got, ref)
    assert len(got) < len(pts)
    view = pts.mean(0) + np.float32([0, 0, 1])
    n_got, n_ref = estimate_normals(pts, 10, view), jax_normals(pts, 10, view)
    np.testing.assert_allclose(n_got, n_ref, atol=1e-6)
    assert np.median(np.abs(n_got[12:, 2])) > 0.9     # the flat cloud's z


@pytest.mark.parametrize("std_ratio", [2.0, 10.0])
def test_exporter_outlier_removal_matches_jax(std_ratio):
    """The exporter's k-d tree outlier removal keeps the indices of the JAX
    exporter's (the counting stage's native backend), on a flat cloud with
    far outliers and on a surface cloud of two touching spheres."""
    from cropnerf_tpu.counting.clustering import \
        statistical_outlier_removal as jax_sor
    from cropnerf_tpu_torch.export.pointcloud import outlier_inliers
    rng = np.random.default_rng(1)
    shell = rng.standard_normal((4000, 3))
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    spheres = np.concatenate([0.25 * shell[:3000],
                              [0.27, -0.18, 0.1] + 0.14 * shell[3000:]])
    spheres[:5] *= 6.0                                 # far outliers
    for pts in (_cloud(), spheres.astype(np.float32)):
        got = outlier_inliers(pts, 20, std_ratio)
        np.testing.assert_array_equal(got, jax_sor(pts, 20, std_ratio))
        assert len(got) < len(pts)


def test_generate_point_cloud_and_export(tmp_path):
    """The port's exporter end to end on the CPU: batches drawn from its
    generator, the kept points of each batch, the outlier removal, and the
    PLY with normals."""
    from cropnerf_tpu_torch.counting.clustering import \
        statistical_outlier_removal
    from cropnerf_tpu_torch.export import pointcloud as tpc
    from cropnerf_tpu_torch.export.ply import read_ply
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from cropnerf_tpu_torch.models.model import model_init
    from test_torch_train import N_IMG, _banks
    m = propfused(TORCH_PRESETS).model
    params = model_init(m, N_IMG, torch.Generator().manual_seed(0), "cpu")
    _, tb = _banks()
    kw = dict(semantic_threshold=-1.0, accumulation_threshold=-1.0)
    pts, cols = tpc.generate_point_cloud(
        params, m, tb, num_points=150, rays_per_batch=CLOUD_RAYS,
        generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    want = []
    for _ in range(3):
        idx = torch.randint(0, tb.num_pixels, (CLOUD_RAYS,), generator=g)
        p, c, k = tpc.depth_points(params, m, tb, idx, **kw)
        want.append(torch.cat([p[k], c[k]], 1).numpy())
    want = np.concatenate(want)[:150]
    want = want[statistical_outlier_removal(want[:, :3], 20, 10.0)]
    np.testing.assert_array_equal(pts, want[:, :3])
    np.testing.assert_array_equal(cols, want[:, 3:])
    path = tpc.export_depth_pointcloud(
        params, m, tb, tmp_path / "semantics_pc.ply", normals_k=8,
        num_points=100, rays_per_batch=CLOUD_RAYS, **kw)
    header = path.read_bytes()[:400].split(b"end_header")[0].decode()
    assert "property float nx" in header
    read, colors = read_ply(path)
    assert read.shape[1] == 3 and colors.shape == read.shape
    assert 50 < len(read) <= 100 and np.isfinite(read).all()
