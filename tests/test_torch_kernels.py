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
