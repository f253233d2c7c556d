"""Kernel modules of the PyTorch port against the JAX Pallas kernels.

The JAX kernels run as their own tests run them on the CPU, in interpret
mode (N=256 with a 128-row tile, plus a full-width case at N=128); the
port's wrappers take their plain PyTorch path for CPU tensors.  A second
set of tests runs the packed weight layout that the CUDA kernels read
through a Python model of the kernels' loops, so the packing is checked
here although the kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas import fused_pe_field as jfield
from cropnerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
from cropnerf_tpu_torch.ops.cuda.common import pack_layers, pad16
from torch_parity import arm, assert_close, np_wbs, to_jax, to_torch  # noqa: F401

# (num_freqs, hidden, n_base, n_top, G, De, Hc, Hs, N): narrow widths, and
# the flagship's full widths at N=128
PE_CASES = [(4, 32, 2, 2, 7, 11, 16, 16, 256),
            (10, 256, 4, 4, 15, 59, 64, 64, 128)]


def _pe_inputs(case, seed=0):
    F, H, n_base, n_top, G, De, Hc, Hs, N = case
    rng = np.random.default_rng(seed)
    enc = 3 * (1 + 2 * F)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    extras = rng.standard_normal((N, De)).astype(np.float32)
    base = np_wbs(rng, [enc] + [H] * n_base)
    top = np_wbs(rng, [H + enc] + [H] * (n_top - 1) + [1 + G])
    color = np_wbs(rng, [G + De, Hc, 3])
    sem = np_wbs(rng, [G, Hs, 1])
    wc0 = color[0]
    color_wbs = [np.pad(wc0[:G], ((1, 0), (0, 0))), wc0[G:], color[1],
                 color[2], color[3]]
    sem_wbs = [np.pad(sem[0], ((1, 0), (0, 0)))] + sem[1:]
    return x, extras, base, top, color_wbs, sem_wbs


@pytest.mark.parametrize("case", PE_CASES, ids=["narrow", "flagship"])
def test_fused_pe_density_matches_jax_kernel(case, arm):
    x, _, base, top, _, _ = _pe_inputs(case)
    F = case[0]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    ref = jfield.fused_pe_density(jnp.asarray(x), s, to_jax(base),
                                  to_jax(top), F, 128, True, 3, 128)
    got = tfield.fused_pe_density(torch.from_numpy(x), to_torch(base),
                                  to_torch(top), F, arm.dtype)
    assert_close(got, ref, arm.tol, "t")


@pytest.mark.parametrize("case", PE_CASES, ids=["narrow", "flagship"])
def test_fused_pe_nerf_matches_jax_kernel(case, arm):
    x, extras, base, top, color_wbs, sem_wbs = _pe_inputs(case)
    F = case[0]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    ref = jfield.fused_pe_nerf(jnp.asarray(x), jnp.asarray(extras), s,
                               to_jax(base), to_jax(top), to_jax(color_wbs),
                               to_jax(sem_wbs), F, False, 128, True, 3, 128)
    got = tfield.fused_pe_nerf(torch.from_numpy(x), torch.from_numpy(extras),
                               to_torch(base), to_torch(top),
                               to_torch(color_wbs), to_torch(sem_wbs), F,
                               arm.dtype)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert_close(g, r, arm.tol, name)


@pytest.mark.parametrize("dims,n", [((15, 64, 1), 256), ((74, 64, 3), 256),
                                    ((63, 256, 256, 16), 128)],
                         ids=["semantic-head", "colour-head", "wide"])
def test_fused_mlp_matches_jax_kernel(dims, n, arm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    wbs = np_wbs(rng, dims)
    ref = jax_fused_mlp(jnp.asarray(x), to_jax(wbs), 128, True)
    got = tmlp.fused_mlp(torch.from_numpy(x), to_torch(wbs), arm.dtype)
    assert_close(got, ref, arm.tol, "y")


def test_selector_matrix_is_jax_copy():
    for F in (4, 10):
        np.testing.assert_array_equal(tfield.pe_selector_matrix(F),
                                      jfield.pe_selector_matrix(F))


def test_cpu_tensors_take_plain_path_without_launch():
    x, extras, base, top, color_wbs, sem_wbs = _pe_inputs(PE_CASES[0])
    before = (tfield.fused_pe_nerf.launches,
              tfield.fused_pe_density.launches, tmlp.fused_mlp.launches)
    t, rgb, sem = tfield.fused_pe_nerf(
        torch.from_numpy(x), torch.from_numpy(extras), to_torch(base),
        to_torch(top), to_torch(color_wbs), to_torch(sem_wbs), 4)
    assert (t.shape, rgb.shape, sem.shape) == ((256, 8), (256, 3), (256, 1))
    tfield.fused_pe_density(torch.from_numpy(x), to_torch(base),
                            to_torch(top), 4)
    tmlp.fused_mlp(torch.randn(5, 15), to_torch(np_wbs(
        np.random.default_rng(0), [15, 64, 1])))
    assert before == (tfield.fused_pe_nerf.launches,
                      tfield.fused_pe_density.launches,
                      tmlp.fused_mlp.launches)


def test_wrappers_reject_bad_inputs():
    wbs = to_torch(np_wbs(np.random.default_rng(0), [15, 64, 1]))
    with pytest.raises(ValueError):                # wrong input width
        tmlp.fused_mlp(torch.randn(5, 14), wbs)
    with pytest.raises(ValueError):                # not float32
        tmlp.fused_mlp(torch.randn(5, 15, dtype=torch.float64), wbs)
    with pytest.raises(ValueError):                # not contiguous
        tmlp.fused_mlp(torch.randn(15, 5).t(), wbs)
    x, extras, base, top, color_wbs, sem_wbs = _pe_inputs(PE_CASES[0])
    with pytest.raises(ValueError):                # extras rows != x rows
        tfield.fused_pe_nerf(torch.from_numpy(x), torch.from_numpy(extras[:7]),
                             to_torch(base), to_torch(top),
                             to_torch(color_wbs), to_torch(sem_wbs), 4)


# --- the packed layout, run through a model of the CUDA kernels' loops ---

def _kernel_layer(a0, a1, wbuf, bbuf, desc):
    """One dense_layer: [A0 | A1] @ W + b over padded widths, f32 sum of
    bf16 operands (csrc/fused_layers.cuh)."""
    w_off, b_off, k, n, ka = desc
    w = wbuf[w_off:w_off + k * n].reshape(k, n).float()
    a = torch.cat([a0[:, :ka], a1[:, :k - ka]], dim=1) if ka < k else a0[:, :k]
    return a.float() @ w + bbuf[b_off:b_off + n]


def _kernel_model_pe_field(x, extras, wbuf, bbuf, meta, heads):
    """csrc/fused_pe_field.cu's control flow in torch, on the packed
    buffers and meta the wrapper builds."""
    (dim, F, enc_cols, enc_pad, de, ex_pad, n_base, n_top, n_color, n_sem,
     t_cols, rgb_cols, sem_cols, hmax) = meta[:14]
    L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
    enc = torch.zeros((x.shape[0], enc_pad))
    enc[:, :enc_cols] = tfield._encode(x, F)
    enc = enc.bfloat16()
    relu_bf16 = lambda v: torch.relu(v).bfloat16()  # noqa: E731
    li, cur = 0, enc
    for _ in range(n_base):
        cur = relu_bf16(_kernel_layer(cur, cur, wbuf, bbuf, L[li]))
        li += 1
    for i in range(n_top):
        v = _kernel_layer(cur, enc if i == 0 else cur, wbuf, bbuf, L[li])
        li += 1
        cur = relu_bf16(v) if i < n_top - 1 else v
    t = cur[:, :t_cols]
    if not heads:
        return t
    tb = cur.bfloat16()
    ex = torch.zeros((x.shape[0], ex_pad))
    ex[:, :de] = extras
    ex = ex.bfloat16()
    outs = []
    for n_layers, first_a1, cols in ((n_color, ex, rgb_cols),
                                     (n_sem, tb, sem_cols)):
        cur = tb
        for i in range(n_layers):
            v = _kernel_layer(cur, first_a1 if i == 0 else cur, wbuf, bbuf,
                              L[li])
            li += 1
            cur = relu_bf16(v) if i < n_layers - 1 else v
        outs.append(cur[:, :cols])
    return (t, *outs)


@pytest.mark.parametrize("case", PE_CASES, ids=["narrow", "flagship"])
def test_packed_layout_reproduces_plain_path(case):
    x, extras, base, top, color_wbs, sem_wbs = _pe_inputs(case, seed=3)
    F = case[0]
    x_t, ex_t = torch.from_numpy(x), torch.from_numpy(extras)
    base_t, top_t = to_torch(base), to_torch(top)
    color_t, sem_t = to_torch(color_wbs), to_torch(sem_wbs)
    wbuf, bbuf, meta = tfield.pack_pe_field(3, F, base_t, top_t)
    got = _kernel_model_pe_field(x_t, None, wbuf, bbuf, meta, False)
    ref = tfield.fused_pe_density_plain(x_t, base_t, top_t, F)
    assert_close(got, ref, 1e-5, "t")
    wbuf, bbuf, meta = tfield.pack_pe_field(3, F, base_t, top_t, color_t,
                                            sem_t, de=extras.shape[1])
    assert max(meta[17::5]) <= 256 and meta[13] == max(meta[17::5])
    got = _kernel_model_pe_field(x_t, ex_t, wbuf, bbuf, meta, True)
    ref = tfield.fused_pe_nerf_plain(x_t, ex_t, base_t, top_t, color_t,
                                     sem_t, F)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert_close(g, r, 1e-5, name)


def test_pack_layers_pads_and_stacks():
    rng = np.random.default_rng(0)
    w_a = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    w_b = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    b = torch.arange(3, dtype=torch.float32)
    w_c = torch.from_numpy(rng.standard_normal((3, 20)).astype(np.float32))
    wbuf, bbuf, descs = pack_layers(
        [([(w_a, 16), (w_b, pad16(7))], b), ([(w_c, 16)], torch.ones(20))],
        torch.device("cpu"))
    assert descs == [0, 0, 32, 16, 16, 32 * 16, 16, 16, 32, 16]
    first = wbuf[:32 * 16].reshape(32, 16).float()
    assert torch.equal(first[:5, :3], w_a.bfloat16().float())
    assert torch.equal(first[16:23, :3], w_b.bfloat16().float())
    assert first[5:16].abs().sum() == 0 and first[:, 3:].abs().sum() == 0
    assert torch.equal(bbuf[:16], torch.cat([b, torch.zeros(13)]))
    second = wbuf[32 * 16:].reshape(16, 32).float()
    assert torch.equal(second[:3, :20], w_c.bfloat16().float())


# --- K1 backward: the port's autograd against the JAX custom VJP ---------

# (num_freqs, hidden, n_base, n_top, G, De, Hc, Hs, C, N, interpret): the
# shapes of test_mega_kernel_interpret_matches_fallback (JAX in interpret
# mode), and the flagship's full widths at N=256 (JAX's reference path)
BWD_CASES = [(4, 32, 2, 2, 7, 19, 24, 16, 2, 256, True),
             (10, 256, 4, 4, 15, 59, 64, 64, 1, 256, False)]
BWD_TOL = {"f32": 1e-4, "bf16": 5e-2}   # bf16: JAX's own kernel-vs-fallback


def _bwd_inputs(case, seed=0):
    F, H, n_base, n_top, G, De, Hc, Hs, C, N, _ = case
    rng = np.random.default_rng(seed)
    enc = 3 * (1 + 2 * F)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    extras = (rng.standard_normal((N, De)) * 0.3).astype(np.float32)
    base = np_wbs(rng, [enc] + [H] * n_base)
    top = np_wbs(rng, [H + enc] + [H] * (n_top - 1) + [1 + G])
    color = np_wbs(rng, [G + De, Hc, 3])
    sem = np_wbs(rng, [G, Hs, C])
    wc0 = color[0]
    color_wbs = [np.pad(wc0[:G], ((1, 0), (0, 0))), wc0[G:], color[1],
                 color[2], color[3]]
    sem_wbs = [np.pad(sem[0], ((1, 0), (0, 0)))] + sem[1:]
    return x, extras, [base, top, color_wbs, sem_wbs]


def _bwd_loss(t, rgb, sm, lib):
    return (lib.sum(lib.sin(t)) + lib.sum(lib.cos(rgb * 2))
            + lib.sum(lib.sin(sm * 0.5)))


@pytest.mark.parametrize("pass_sem", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=["jax-test", "flagship"])
def test_fused_pe_nerf_backward_matches_jax(case, pass_sem, arm):
    import jax
    x, extras, groups = _bwd_inputs(case)
    F, interpret = case[0], case[-1]
    s = jnp.asarray(jfield.pe_selector_matrix(F))

    def jloss(x, ex, base, top, color, sem):
        t, rgb, sm = jfield.fused_pe_nerf(x, ex, s, base, top, color, sem, F,
                                          pass_sem, 128, interpret, 3, 128)
        return _bwd_loss(t, rgb, sm, jnp)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5))(
        jnp.asarray(x), jnp.asarray(extras), *[to_jax(g) for g in groups])
    xt, ext = torch.from_numpy(x), torch.from_numpy(extras)
    tg = [[w.requires_grad_(True) for w in to_torch(g)] for g in groups]
    for t in (xt, ext):
        t.requires_grad_(True)
    out = tfield.fused_pe_nerf(xt, ext, *tg, F, arm.dtype,
                               pass_sem_grad=pass_sem)
    _bwd_loss(*out, torch).backward()
    tol = BWD_TOL[arm.name]
    assert_close(xt.grad, ref[0], tol, "dx")
    assert_close(ext.grad, ref[1], tol, "dextras")
    for gi, (got_g, ref_g) in enumerate(zip(tg, ref[2:])):
        for wi, (w, r) in enumerate(zip(got_g, ref_g)):
            assert_close(w.grad, r, tol, f"group {gi} tensor {wi}")
    # the semantic head's cotangent reaches the trunk only with pass_sem
    sem_only = tfield.fused_pe_nerf(xt, ext, *tg, F, arm.dtype,
                                    pass_sem_grad=pass_sem)[2].sum()
    trunk_grad = torch.autograd.grad(sem_only, tg[0][0], allow_unused=True)[0]
    assert (trunk_grad is not None and trunk_grad.abs().sum() > 0) == pass_sem


def _kernel_model_pe_field_bwd(x, extras, wbuf, bbuf, meta, g_t, g_rgb,
                               g_sem, pass_sem):
    """csrc/fused_pe_field_bwd.cu's three passes in torch, on the packed
    buffers and meta the wrapper builds: the tile pass (recompute with the
    workspace slots, backprop with f32 cotangents rounded to bf16 as
    product operands, per-layer bias column sums, dx, dextras), the
    split-K weight-gradient pass Aᵀ·G over the slots, and the sums into the
    packed f32 gradient buffers."""
    (dim, F, enc_cols, enc_pad, de, ex_pad, n_base, n_top, n_color, n_sem,
     t_cols, rgb_cols, sem_cols, _) = meta[:14]
    L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
    n_layers = len(L)
    top0, c0 = n_base, n_base + n_top
    s0 = c0 + n_color
    N = x.shape[0]
    relu_bf16 = lambda v: torch.relu(v).bfloat16()  # noqa: E731
    enc = torch.zeros((N, enc_pad))
    enc[:, :enc_cols] = tfield._encode(x, F)
    enc = enc.bfloat16()
    ex = torch.zeros((N, ex_pad))
    ex[:, :de] = extras
    ex = ex.bfloat16()

    act = {}                                  # the workspace's act slots

    def inputs(l):                            # layer_inputs in the source
        a0 = enc if l == 0 else act[c0 - 1] if l == s0 else act[l - 1]
        a1 = enc if l == top0 else ex if l == c0 else a0
        return a0, a1

    for l in range(n_layers):                 # forward recompute
        if l in (s0 - 1, n_layers - 1):
            continue                          # heads' outputs: not read
        a0, a1 = inputs(l)
        v = _kernel_layer(a0, a1, wbuf, bbuf, L[l])
        act[l] = v.bfloat16() if l == c0 - 1 else relu_bf16(v)

    G = {}
    dbbuf = torch.zeros(bbuf.shape)

    def emit(l, g, mask):
        if mask is not None:
            g = torch.where(mask.float() > 0, g, 0.0)
        G[l] = g.bfloat16()
        dbbuf[L[l][1]:L[l][1] + L[l][3]] = g.sum(0)
        return g

    def bp(g, l, c_lo, cw):
        w_off, _, k, n, _ = L[l]
        w = wbuf[w_off:w_off + k * n].reshape(k, n).float()
        return g.bfloat16().float() @ w[c_lo:c_lo + cw].T

    def padded(g, cols, n):
        out = torch.zeros((N, n))
        out[:, :cols] = g
        return out

    tp = L[c0 - 1][3]
    gt = padded(g_t, t_cols, tp)
    dex = None
    for first, last, g_in, cols in ((c0, s0 - 1, g_rgb, rgb_cols),
                                    (s0, n_layers - 1, g_sem, sem_cols)):
        g = emit(last, padded(g_in, cols, L[last][3]), None)
        for l in range(last, first, -1):
            g = emit(l - 1, bp(g, l, 0, L[l][2]), act[l - 1])
        ka, k = L[first][4], L[first][2]
        if first == c0:
            gt = gt + bp(g, first, 0, ka)
            dex = bp(g, first, ka, k - ka)[:, :de]
        elif pass_sem:
            gt = gt + bp(g, first, 0, k)
    g = emit(c0 - 1, gt, None)
    for l in range(c0 - 1, top0, -1):
        g = emit(l - 1, bp(g, l, 0, L[l][2]), act[l - 1])
    ka, k = L[top0][4], L[top0][2]
    g_h = emit(top0 - 1, bp(g, top0, 0, ka), act[top0 - 1])
    genc = bp(g, top0, ka, k - ka)
    g = g_h
    for l in range(top0 - 1, 0, -1):
        g = emit(l - 1, bp(g, l, 0, L[l][2]), act[l - 1])
    genc = genc + bp(g, 0, 0, L[0][2])

    col = torch.arange(enc_pad)
    sin_end = dim * (1 + F)
    pre = torch.zeros((N, enc_pad))
    pre[:, :enc_cols] = x @ torch.from_numpy(tfield.pe_selector_matrix(F))
    d_pre = torch.where(col < dim, genc,
                        torch.where(col < sin_end, genc * torch.cos(pre),
                                    -genc * torch.sin(pre)))
    dx = d_pre[:, :enc_cols] @ torch.from_numpy(tfield.pe_selector_matrix(F)).T

    dwbuf = torch.zeros(wbuf.shape)
    for l in range(n_layers):                 # split-K pass: Aᵀ·G
        w_off, _, k, n, ka = L[l]
        a0, a1 = inputs(l)
        a = torch.cat([a0[:, :ka], a1[:, :k - ka]], dim=1)
        dwbuf[w_off:w_off + k * n] = (a.float().T @ G[l].float()).reshape(-1)
    return dx, dex, dwbuf, dbbuf


@pytest.mark.parametrize("pass_sem", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=["jax-test", "flagship"])
def test_backward_kernel_model_reproduces_plain_autograd(case, pass_sem):
    x, extras, groups = _bwd_inputs(case, seed=4)
    F = case[0]
    rng = np.random.default_rng(5)
    xt, ext = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(extras).requires_grad_(True)
    tg = [[w.requires_grad_(True) for w in to_torch(g)] for g in groups]
    outs = tfield.fused_pe_nerf_plain(xt, ext, *tg, F,
                                      pass_sem_grad=pass_sem)
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
            for o in outs]
    flat_w = [w for g in tg for w in g]
    ref = torch.autograd.grad(outs, [xt, ext, *flat_w], cots)

    with torch.no_grad():
        wbuf, bbuf, meta = tfield.pack_pe_field(3, F, *tg, de=extras.shape[1])
        dx, dex, dwbuf, dbbuf = _kernel_model_pe_field_bwd(
            xt, ext, wbuf, bbuf, meta, *cots, pass_sem)
        grads = tfield.unpack_pe_field_grads(dwbuf, dbbuf, meta, *tg)
    got = [dx, dex] + [g for group in grads for g in group]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = ((g - r).abs().max() / r.abs().max().clamp_min(1e-6)).item()
        assert err <= 2e-2, (i, err)
