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
from cropnerf_tpu_torch.ops.cuda.common import MAX_WIDTH, pack_layers, pad16
from torch_parity import arm, assert_close, np_wbs, to_jax, to_torch  # noqa: F401

# (num_freqs, hidden, n_base, n_top, G, De, Hc, Hs, N): narrow widths, the
# flagship's full widths at N=128, and [w512]'s (a 512-wide trunk and
# semantic head: the kernels' wide programs)
PE_CASES = [(4, 32, 2, 2, 7, 11, 16, 16, 256),
            (10, 256, 4, 4, 15, 59, 64, 64, 128),
            (10, 512, 4, 4, 15, 59, 64, 512, 128)]
PE_IDS = ["narrow", "flagship", "w512"]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


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


@pytest.mark.parametrize("case", PE_CASES, ids=PE_IDS)
def test_fused_pe_density_matches_jax_kernel(case, arm):
    x, _, base, top, _, _ = _pe_inputs(case)
    F = case[0]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    ref = jfield.fused_pe_density(jnp.asarray(x), s, to_jax(base),
                                  to_jax(top), F, 128, True, 3, 128)
    got = tfield.fused_pe_density(torch.from_numpy(x), to_torch(base),
                                  to_torch(top), F, arm.dtype)
    assert_close(got, ref, arm.tol, "t")


@pytest.mark.parametrize("case", PE_CASES, ids=PE_IDS)
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
    """One dense layer: [A0 | A1] @ W + b over padded widths, f32 sum of
    bf16 operands."""
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


@pytest.mark.parametrize("case", PE_CASES[:2], ids=PE_IDS[:2])
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
    assert max(meta[17::5]) <= MAX_WIDTH and meta[13] == max(meta[17::5])
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


# --- the forward program (ops/cuda/pe_plan.py build_forward_plan) --------

def _kernel_model_pe_field_fwd(x, extras, wbuf, bbuf, meta, heads):
    """csrc/fused_pe_field.cu's program run op by op in torch on what the
    wrapper hands the kernel: the wgmma weight image gathered from the
    packed weights, the packed biases, 128-row tiles (rows past N zero).
    Each product sums its operands in float32; the activations and the
    encoding take the weights' dtype (bf16 as on the card, float32 for the
    f32 arm).  Returns t, or (t, rgb_raw, sem_raw) with the heads."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    cd = wbuf.dtype
    plan = P.build_forward_plan(meta, heads)
    img = P.weight_image(wbuf, P.image_index(meta, plan))
    h = plan.header
    N = x.shape[0]
    n_pad = -(-N // P.TILE) * P.TILE

    def padded(t, cols):
        out = torch.zeros((n_pad, cols))
        out[:N, :t.shape[1]] = t
        return out

    enc = torch.zeros((n_pad, h[P.H_ENC_PAD]))
    enc[:, :h[P.H_ENC_COLS]] = tfield._encode(padded(x, h[P.H_DIM]), h[P.H_FREQS])
    bufs = {P.ENC: enc.to(cd), P.ACT: torch.zeros((n_pad, h[P.H_ACT_W]), dtype=cd),
            P.TB: torch.zeros((n_pad, h[P.H_TB_W]), dtype=cd)}
    cols = {P.T_OUT: h[P.H_T_COLS], P.RGB_OUT: h[P.H_RGB_COLS],
            P.SEM_OUT: h[P.H_SEM_COLS]}
    outs = {}
    for op in plan.ops:
        n, K, ka = op[P.O_N], op[P.O_K], op[P.O_KA]
        if op[P.O_KIND] == P.EX:
            bufs[P.ACT][:, :n] = padded(extras, n).to(cd)
            continue
        b = P.from_pass_image(img[op[P.O_IMG]:op[P.O_IMG] + K * n], K, n)
        a = torch.cat([bufs[op[P.O_A0]][:, :ka], bufs[op[P.O_A1]][:, :K - ka]], 1)
        acc = a.float() @ b.float()
        nv, epi = op[P.O_NVALID], op[P.O_EPI]
        acc[:, :nv] += bbuf[op[P.O_BOFF]:op[P.O_BOFF] + nv]
        if epi == P.RELU:
            bufs[P.ACT][:, :n] = torch.relu(acc).to(cd)
            continue
        if epi in (P.LINEAR, P.T_OUT):
            bufs[P.TB][:, :n] = acc.to(cd)
        if epi != P.LINEAR:
            outs[epi] = acc[:N, :cols[epi]]
    if not heads:
        return outs[P.T_OUT]
    return outs[P.T_OUT], outs[P.RGB_OUT], outs[P.SEM_OUT]


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
def test_wide_kernel_models_reproduce_plain_path(heads):
    """[w512]'s forward program (a wide program) on a float32 weight image
    gives the float32 plain version's outputs to 1e-5 of their largest
    value: the same products, biases and relus, summed in another order.
    (In bf16 a few activations of the 512-wide layers round to the other
    neighbour when summed in another order, 8.5e-4 of max here; the
    program's bf16 arithmetic is held against the JAX kernels in
    test_forward_kernel_model_matches_jax_kernel.)"""
    case = PE_CASES[2]
    x, ex, groups, (wbuf, bbuf, meta) = _fwd_case(case, heads, torch.float32)
    F = case[0]
    assert meta[13] == 512
    got = _kernel_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    if heads:
        ref = tfield.fused_pe_nerf_plain(x, ex, *groups, F, torch.float32)
    else:
        got = (got,)
        ref = (tfield.fused_pe_density_plain(x, *groups, F, torch.float32),)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))



def _split_halves(img, op, dtype):
    """Each block's B operand of a wide forward's product op, [K, N // 2]:
    the slabs ``pe_plan.half_slab_index`` names, each read back as the
    K-major core-matrix image of its rows of the block's half."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    half = op[P.O_N] // 2
    out = []
    for rank in range(P.CLUSTER):
        slabs = [P.from_core_k_major(img[torch.tensor(idx)], len(idx) // half,
                                     half)
                 for idx in P.half_slab_index(op, rank)]
        out.append(torch.cat(slabs).to(dtype))
    return out


def _split_model_pe_field_fwd(x, extras, wbuf, bbuf, meta, heads):
    """csrc/fused_pe_field.cu's wide forward as its cluster runs it: two
    blocks, each with its own copy of the rows' encoding, activation and t
    tiles, computing one half of every product's columns from the half
    slabs its producer copies, then writing that half into its own tiles
    and its peer's (Mirror); each output's columns come from the block
    that owns them.  The two copies must stay equal.  Returns t, or (t,
    rgb_raw, sem_raw) with the heads."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    cd = wbuf.dtype
    plan = P.build_forward_plan(meta, heads)
    img = P.weight_image(wbuf, P.image_index(meta, plan))
    h = plan.header
    assert P.width_class([h[P.H_ACT_W]]) == 1
    N = x.shape[0]
    n_pad = -(-N // P.TILE) * P.TILE
    xs, exs = torch.zeros((n_pad, h[P.H_DIM])), torch.zeros((n_pad, h[P.H_ACT_W]))
    xs[:N] = x
    if heads:
        exs[:N, :extras.shape[1]] = extras
    enc = torch.zeros((n_pad, h[P.H_ENC_PAD]))
    enc[:, :h[P.H_ENC_COLS]] = tfield._encode(xs, h[P.H_FREQS])
    blocks = [{P.ENC: enc.to(cd),
               P.ACT: torch.zeros((n_pad, h[P.H_ACT_W]), dtype=cd),
               P.TB: torch.zeros((n_pad, h[P.H_TB_W]), dtype=cd)}
              for _ in range(P.CLUSTER)]
    cols = {P.T_OUT: h[P.H_T_COLS], P.RGB_OUT: h[P.H_RGB_COLS],
            P.SEM_OUT: h[P.H_SEM_COLS]}
    outs = {}
    for op in plan.ops:
        n, K, ka = op[P.O_N], op[P.O_K], op[P.O_KA]
        if op[P.O_KIND] == P.EX:               # each block loads the extras
            for bufs in blocks:
                bufs[P.ACT][:, :n] = exs[:, :n].to(cd)
            continue
        half, epi = n // 2, op[P.O_EPI]
        accs = []
        for rank, (bufs, b) in enumerate(zip(blocks, _split_halves(img, op, cd))):
            a = torch.cat([bufs[op[P.O_A0]][:, :ka],
                           bufs[op[P.O_A1]][:, :K - ka]], 1)
            acc = a.float() @ b.float()
            c = torch.arange(rank * half, (rank + 1) * half)
            live = c < op[P.O_NVALID]
            acc[:, live] += bbuf[op[P.O_BOFF] + c[live]]
            accs.append(acc)
        for rank, acc in enumerate(accs):      # every product read, then the stores
            c = slice(rank * half, (rank + 1) * half)
            if epi in (P.RELU, P.T_OUT):
                v = (torch.relu(acc) if epi == P.RELU else acc).to(cd)
                for bufs in blocks:            # its own copy and its peer's
                    bufs[P.ACT if epi == P.RELU else P.TB][:, c] = v
            if epi in cols:
                out = outs.setdefault(epi, torch.full((n_pad, cols[epi]), float("nan")))
                width = max(0, min(half, cols[epi] - rank * half))
                out[:, rank * half:rank * half + width] = acc[:, :width]
    for buf in (P.ENC, P.ACT, P.TB):
        assert torch.equal(blocks[0][buf], blocks[1][buf]), buf
    got = [outs[e][:N] for e in ((P.T_OUT, P.RGB_OUT, P.SEM_OUT) if heads
                                 else (P.T_OUT,))]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return tuple(got) if heads else got[0]


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
def test_wide_split_model_reproduces_plain_path(heads):
    """[w512]'s forward program as the wide forward's cluster runs it
    (``_split_model_pe_field_fwd``: two blocks, each computing its half of
    every product's columns from its half slabs and mirroring it) on a
    float32 weight image gives the float32 plain version's outputs to
    1e-5 of their largest value, as the whole program does
    (test_wide_kernel_models_reproduce_plain_path), and the whole
    program's values bit for bit in bf16 (each column's sum is the same
    sum, in the same k order)."""
    case = PE_CASES[2]
    F = case[0]
    x, ex, groups, (wbuf, bbuf, meta) = _fwd_case(case, heads, torch.float32)
    got = _split_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    if heads:
        ref = tfield.fused_pe_nerf_plain(x, ex, *groups, F, torch.float32)
    else:
        got = (got,)
        ref = (tfield.fused_pe_density_plain(x, *groups, F, torch.float32),)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))
    x, ex, _, (wbuf, bbuf, meta) = _fwd_case(case, heads)
    split = _split_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    whole = _kernel_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    for g, w in zip(split if heads else (split,), whole if heads else (whole,)):
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
def test_wide_forward_half_slabs_cover_each_product(heads):
    """``produce_half_slabs`` at [w512]'s forward programs: for every
    product the two blocks' copies take each element of its B image once
    between them, each block the same k rows of its own columns in every
    slab, as 16-byte-aligned runs whose slab fits a 16 KB stage (32 rows
    of 256 columns)."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, _, (wbuf, _, meta) = _fwd_case(PE_CASES[2], heads)
    plan = P.build_forward_plan(meta, heads)
    img = P.image_index(meta, plan)
    for op in (op for op in plan.ops if op[P.O_KIND] == P.FWD):
        N, K, at = op[P.O_N], op[P.O_K], op[P.O_IMG]
        halves = [P.half_slab_index(op, r) for r in range(P.CLUSTER)]
        flat = sorted(i for hs in halves for slab in hs for i in slab)
        assert flat == list(range(at, at + K * N))
        for hs in halves:
            assert len(hs) == -(-K // P.SLAB_K)
            for slab in hs:
                assert len(slab) * 2 <= P.SLAB_K * P.MAX_N * 2
                runs = [slab[i:i + N // 2 * 8]
                        for i in range(0, len(slab), N // 2 * 8)]
                assert all(r[0] * 2 % 16 == 0 and r == list(range(r[0], r[0] + len(r)))
                           for r in runs)
        # block r's columns: the B matrix's [:, r N/2:(r+1) N/2]
        b = P.from_core_k_major(img[at:at + K * N], K, N)
        for r, hs in enumerate(halves):
            got = torch.cat([P.from_core_k_major(img[torch.tensor(s)],
                                                 len(s) // (N // 2), N // 2)
                             for s in hs])
            assert torch.equal(got, b[:, r * N // 2:(r + 1) * N // 2])


# the forward kernel's dynamic shared memory and ring stages
# (``pe_plan.fwd_smem``, the mirror of fused_pe_field.cu's ``fwd_layout``):
# up to 256 wide a warpgroup's region each, the biases, 64-row slabs (the
# layouts before the wide forward's split, unchanged); [w512]'s wide
# programs a region a warpgroup with the 512-wide activation tile, the
# biases, the handshake barriers and 16 KB stages of 32 rows of the
# block's half
FWD_SMEM = {("narrow", True): (218_624, 6), ("narrow", False): (218_112, 6),
            ("flagship", True): (226_048, 4), ("flagship", False): (225_152, 4),
            ("w512", True): (218_624, 3), ("w512", False): (232_320, 4)}


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("case", PE_CASES, ids=PE_IDS)
def test_forward_layout_mirror(case, heads):
    """``pe_plan.fwd_smem`` at the narrow, flagship and [w512] programs:
    every one fits a block's shared memory with at least the three stages
    ``PingPong`` needs; the values are those the layouts give (the card's
    C function is held to the mirror in tests/test_torch_gpu.py)."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, _, (_, _, meta) = _fwd_case(case, heads)
    h = P.build_forward_plan(meta, heads).header
    total, stages = P.fwd_smem(h)
    assert total <= 232_448 and stages >= P.FWD_MIN_STAGES
    assert (total, stages) == FWD_SMEM[(PE_IDS[PE_CASES.index(case)], heads)]

def _f32_weight_buffer(groups, F, de):
    """pack_pe_field's weight buffer in float32, for the f32 arm's run of
    the programs: the same layers and blocks, unrounded."""
    from cropnerf_tpu_torch.ops.cuda.common import pad16
    layers, _ = tfield._pe_layers(3, F, *groups, de=de)
    blocks = []
    for parts, bias in layers:
        for w, k_pad in parts:
            blk = torch.zeros((k_pad, pad16(bias.numel())))
            blk[:w.shape[0], :w.shape[1]] = w
            blocks.append(blk.reshape(-1))
    return torch.cat(blocks)


def _fwd_case(case, heads, dtype=torch.bfloat16, seed=3):
    x, extras, base, top, color_wbs, sem_wbs = _pe_inputs(case, seed=seed)
    groups = [to_torch(g) for g in ((base, top, color_wbs, sem_wbs) if heads
                                    else (base, top))]
    de = extras.shape[1] if heads else 0
    wbuf, bbuf, meta = tfield.pack_pe_field(3, case[0], *groups, de=de)
    if dtype == torch.float32:
        f32 = _f32_weight_buffer(groups, case[0], de)
        assert f32.shape == wbuf.shape and torch.equal(f32.bfloat16(), wbuf)
        wbuf = f32
    return (torch.from_numpy(x), torch.from_numpy(extras), groups,
            (wbuf, bbuf, meta))


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
@pytest.mark.parametrize("case", PE_CASES[:2], ids=PE_IDS[:2])
def test_forward_kernel_model_reproduces_plain_path(case, heads):
    """The forward program on the weight image gives the plain version's
    outputs: the same bf16 operands and rounding points, float32 sums in
    another order (tolerance 1e-5 of max |plain|, as the packed layout's)."""
    x, ex, groups, (wbuf, bbuf, meta) = _fwd_case(case, heads)
    got = _kernel_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    if heads:
        ref = tfield.fused_pe_nerf_plain(x, ex, *groups, case[0])
        for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
            assert_close(g, r, 1e-5, name)
    else:
        assert_close(got, tfield.fused_pe_density_plain(x, *groups, case[0]),
                     1e-5, "t")


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
@pytest.mark.parametrize("case", PE_CASES, ids=PE_IDS)
def test_forward_kernel_model_matches_jax_kernel(case, heads, arm):
    """The forward program against the JAX kernels in interpret mode, in
    both arms at the arm's tolerance (f32 1e-4, bf16 2e-2): the f32 arm
    runs the program on a float32 image and float32 activations."""
    x, ex, _, (wbuf, bbuf, meta) = _fwd_case(case, heads, arm.dtype, seed=0)
    _, _, base, top, color_wbs, sem_wbs = _pe_inputs(case, seed=0)
    F = case[0]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    got = _kernel_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    if heads:
        ref = jfield.fused_pe_nerf(jnp.asarray(x.numpy()), jnp.asarray(ex.numpy()),
                                   s, to_jax(base), to_jax(top),
                                   to_jax(color_wbs), to_jax(sem_wbs), F, False,
                                   128, True, 3, 128)
        for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
            assert_close(g, r, arm.tol, name)
    else:
        ref = jfield.fused_pe_density(jnp.asarray(x.numpy()), s, to_jax(base),
                                      to_jax(top), F, 128, True, 3, 128)
        assert_close(got, ref, arm.tol, "t")


def _check_weight_image(plan, wbuf, meta):
    """Each product op's B, decoded from the weight image's K-major
    core-matrix layout, is the layer's W block (forward) or the Wᵀ rows it
    produces (backward), zero-padded to the op's N."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    img = P.weight_image(wbuf, P.image_index(meta, plan))
    assert img.numel() == plan.header[P.H_IMG_ELEMS]
    L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
    products = [op for op in plan.ops if op[P.O_KIND] in (P.FWD, P.BWD)]
    assert len(products) == len(plan.images)
    for op, (layer, transposed, row0, rows, K, N) in zip(products, plan.images):
        assert (op[P.O_K], op[P.O_N]) == (K, N) and N in (16, 32, 64, 128, 256, 512,
                                                          1024)
        assert K % 16 == 0 and 0 < op[P.O_KA] <= K
        b = P.from_pass_image(img[op[P.O_IMG]:op[P.O_IMG] + K * N], K, N)
        w_off, _, k, n, _ = L[layer]
        w = wbuf[w_off:w_off + k * n].reshape(k, n)
        want = torch.zeros((K, N), dtype=wbuf.dtype)
        if transposed:
            want[:n, :rows] = w[row0:row0 + rows].T
        else:
            want[:, :n] = w
        assert torch.equal(b, want)


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
@pytest.mark.parametrize("case", PE_CASES, ids=PE_IDS)
def test_pe_fwd_plan_runs_each_layer_once(case, heads):
    """One FWD op per layer in order, the EX op before the colour head, the
    output epilogues on the trunk's, colour head's and semantic head's last
    layers, RELU elsewhere; each product's B in the weight image; no
    masks, workspace or tasks."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, _, (wbuf, _, meta) = _fwd_case(case, heads)
    plan = P.build_forward_plan(meta, heads)
    n_base, n_top, n_color, n_sem = meta[6:10]
    n_layers = n_base + n_top + (n_color + n_sem if heads else 0)
    fwd = [op for op in plan.ops if op[P.O_KIND] == P.FWD]
    assert [op[P.O_KIND] for op in plan.ops] == (
        [P.FWD] * (n_base + n_top) + ([P.EX] + [P.FWD] * (n_color + n_sem)
                                      if heads else []))
    assert [layer for layer, *_ in plan.images] == list(range(n_layers))
    last = {n_base + n_top - 1: P.T_OUT}
    if heads:
        last.update({n_base + n_top + n_color - 1: P.RGB_OUT,
                     n_layers - 1: P.SEM_OUT})
    assert [op[P.O_EPI] for op in fwd] == [last.get(l, P.RELU)
                                           for l in range(n_layers)]
    assert all(op[P.O_MASK] == -1 and op[P.O_WS] == -1 for op in plan.ops)
    assert plan.tasks == [] and plan.slots == {}
    h = plan.header
    assert (h[P.H_MASK_WORDS], h[P.H_WS_COLS], h[P.H_N_TASKS], h[P.H_STORE]) == (0, 0, 0, 0)
    assert (h[P.H_RGB_COLS], h[P.H_SEM_COLS]) == ((3, 1) if heads else (0, 0))
    _check_weight_image(plan, wbuf, meta)
    # the products are those of the backward's recompute, with the heads'
    # output layers on top
    if heads:
        bwd = P.build_plan(meta, True, False, True)
        rec = [op for op in bwd.ops if op[P.O_KIND] == P.FWD]
        keep = [i for i, (layer, *_) in enumerate(plan.images)
                if layer not in (n_base + n_top + n_color - 1, n_layers - 1)]
        assert [[fwd[i][f] for f in (P.O_N, P.O_K, P.O_A0, P.O_A1, P.O_KA, P.O_BOFF)]
                for i in keep] == [[op[f] for f in (P.O_N, P.O_K, P.O_A0, P.O_A1,
                                                    P.O_KA, P.O_BOFF)] for op in rec]


# --- K1 backward: the port's autograd against the JAX custom VJP ---------

# (num_freqs, hidden, n_base, n_top, G, De, Hc, Hs, C, N, interpret): the
# shapes of test_mega_kernel_interpret_matches_fallback (JAX in interpret
# mode), the flagship's full widths at N=256 and [w512]'s (JAX's reference
# path)
BWD_CASES = [(4, 32, 2, 2, 7, 19, 24, 16, 2, 256, True),
             (10, 256, 4, 4, 15, 59, 64, 64, 1, 256, False),
             (10, 512, 4, 4, 15, 59, 64, 512, 1, 256, False)]
BWD_IDS = ["jax-test", "flagship", "w512"]
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
@pytest.mark.parametrize("case", BWD_CASES[:2], ids=BWD_IDS[:2])
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
                               g_sem, pass_sem, need_dw=True):
    """csrc/fused_pe_field_bwd.cu's three passes in torch, on what the
    wrapper hands the kernel (ops/cuda/pe_plan.py): the tile program run
    op by op on 64-row blocks (products from the wgmma weight image, relu
    masks kept from the recompute, cotangents in place, f32 cotangents
    rounded to bf16 as product operands, per-block bias column sums, each
    A and G written to its workspace slot in the chunk-major block
    layout), dx, dextras; the weight-gradient tasks Aᵀ·G read back from
    the workspace per split; the fixed-order sums.  A meta without heads
    (n_color 0) runs the trunk alone; need_dw False returns dx alone.  The
    activations and operands take the weights' dtype (bf16 as on the card,
    float32 for the f32 arm)."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    cd = wbuf.dtype
    heads = meta[8] > 0
    plan = P.build_plan(meta, heads, pass_sem, need_dw)
    img = P.weight_image(wbuf, P.image_index(meta, plan))
    h = plan.header
    dim, F, enc_cols, enc_pad = h[P.H_DIM], h[P.H_FREQS], h[P.H_ENC_COLS], h[P.H_ENC_PAD]
    de, tw = h[P.H_DE], h[P.H_TB_W]
    N = x.shape[0]
    n_pad = -(-N // P.TILE) * P.TILE
    rows = torch.arange(n_pad)

    def padded(t, cols):
        out = torch.zeros((n_pad, cols))
        if t is not None:
            out[:N, :t.shape[1]] = t
        return out

    xs = padded(x, dim)
    ws = torch.zeros(P.ws_elems(plan, N), dtype=cd)

    def store(col, t):
        if col >= 0:
            ws[P.ws_index(col, t.shape[1], n_pad, rows,
                          torch.arange(t.shape[1]))] = t.to(cd)

    enc = torch.zeros((n_pad, enc_pad))
    enc[:, :enc_cols] = tfield._encode(xs, F)
    bufs = {P.ENC: enc.to(cd),
            P.ACT: torch.zeros((n_pad, h[P.H_ACT_W]), dtype=cd),
            P.TB: torch.zeros((n_pad, tw), dtype=cd)}
    store(h[P.H_ENC_SLOT], bufs[P.ENC])
    gt = padded(g_t, tw)
    genc = torch.zeros((n_pad, enc_pad))
    dex = torch.zeros((n_pad, de)) if heads else None
    masks = {}
    bpart = torch.zeros((n_pad // P.BLOCK, h[P.H_TOTAL_B]))

    def emit_g(op, v):
        if op[P.O_MASK] >= 0:
            v = torch.where(masks[op[P.O_MASK]], v, 0.0)
        n = op[P.O_N]
        bufs[P.ACT][:, :n] = v.to(cd)
        if op[P.O_BOFF] >= 0:
            b, nv = op[P.O_BOFF], op[P.O_NVALID]
            bpart[:, b:b + nv] = v.reshape(-1, P.BLOCK, n).sum(1)[:, :nv]
        store(op[P.O_WS], bufs[P.ACT][:, :n])

    for op in plan.ops:
        kind, n, K, ka = op[P.O_KIND], op[P.O_N], op[P.O_K], op[P.O_KA]
        if kind == P.EX:
            bufs[P.ACT][:, :n] = padded(extras, n).to(cd)
            store(op[P.O_WS], bufs[P.ACT][:, :n])
            continue
        if kind == P.EMIT:
            src = op[P.O_EPI]
            v = (gt[:, :n] if src == P.SRC_GT
                 else padded(g_rgb if src == P.SRC_RGB else g_sem, n))
            emit_g(op, v.clone())
            continue
        b = P.from_pass_image(img[op[P.O_IMG]:op[P.O_IMG] + K * n], K, n)
        a = torch.cat([bufs[op[P.O_A0]][:, :ka], bufs[op[P.O_A1]][:, :K - ka]], 1)
        acc = a.float() @ b.float()
        epi = op[P.O_EPI]
        if kind == P.FWD:
            nv = op[P.O_NVALID]
            acc[:, :nv] += bbuf[op[P.O_BOFF]:op[P.O_BOFF] + nv]
            hb = (torch.relu(acc) if epi == P.RELU else acc).to(cd)
            bufs[P.ACT if epi == P.RELU else P.TB][:, :n] = hb
            if op[P.O_MASK] >= 0:
                masks[op[P.O_MASK]] = hb.float() > 0
            store(op[P.O_WS], hb)
        elif epi == P.G_MASKED:
            emit_g(op, acc)
        else:
            c = op[P.O_COL]
            if epi == P.GT_ADD:
                gt[:, c:c + n] += acc
            elif epi == P.DEX:
                if c < de:
                    dex[:, c:c + n] = acc[:, :min(n, de - c)]
            elif epi == P.GENC_SET:
                genc[:, c:c + n] = acc
            else:
                genc[:, c:c + n] += acc

    col = torch.arange(enc_pad)
    sin_end = dim * (1 + F)
    sel = torch.from_numpy(tfield.pe_selector_matrix(F))
    pre = torch.zeros((n_pad, enc_pad))
    pre[:, :enc_cols] = xs @ sel
    d_pre = torch.where(col < dim, genc,
                        torch.where(col < sin_end, genc * torch.cos(pre),
                                    -genc * torch.sin(pre)))
    dx = (d_pre[:, :enc_cols] @ sel.T)[:N]
    if not need_dw:
        return dx, None, None, None

    splits, per = P.dw_splits(N, len(plan.tasks))
    wpart = torch.zeros((splits, h[P.H_TOTAL_W]))
    for sp in range(splits):                  # split-K pass: Aᵀ·G per task
        r = rows[sp * per * P.BLOCK:(sp + 1) * per * P.BLOCK]
        for t in plan.tasks:
            m, nn, j0 = t[P.T_M_VALID], t[P.T_N], t[P.T_J0]
            cols = min(t[P.T_BN], nn - j0)
            a = ws[P.ws_index(t[P.T_A_COL], t[P.T_A_W], n_pad, r,
                              t[P.T_I0] + torch.arange(m))]
            g = ws[P.ws_index(t[P.T_G_COL], t[P.T_G_W], n_pad, r,
                              j0 + torch.arange(cols))]
            o = t[P.T_W_OFF] + t[P.T_W_ROW0] * nn
            wpart[sp, o:o + m * nn].view(m, nn)[:, j0:j0 + cols] = (
                a.float().T @ g.float())
    dwbuf = wpart.sum(0)
    dbbuf = bpart.sum(0)
    return dx, (dex[:N, :de] if heads else None), dwbuf, dbbuf


@pytest.mark.parametrize("pass_sem", [False, True])
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
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


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_backward_kernel_model_matches_jax(case, heads, arm):
    """The backward's three passes (K1 with the heads, K2 without) against
    the JAX VJP of fused_pe_nerf / fused_pe_density at the case's path (in
    interpret mode or the reference path), [w512]'s wide programs
    included.  The float32 arm runs the programs on a float32 image and
    holds dx, dextras and every weight and bias gradient to 1e-4 of its
    largest value.  In the bf16 arm the two frameworks round some
    activations to the other bf16 neighbour (test_stream_programs_match_jax
    says how that spreads), so each gradient is held to 2e-2 of max against
    autograd of the plain version (which rounds where the program does, as
    test_backward_kernel_model_reproduces_plain_autograd holds it) and in
    relative L2 to JAX's no further than the plain version's plus 1e-2."""
    import jax
    x, extras, groups = _bwd_inputs(case, seed=12)
    F, interpret = case[0], case[-1]
    groups = groups if heads else groups[:2]
    rng = np.random.default_rng(13)
    n = x.shape[0]
    cols = [groups[1][-2].shape[1]] + ([3, groups[3][-2].shape[1]] if heads
                                       else [])
    cots = [rng.standard_normal((n, c)).astype(np.float32) for c in cols]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    if heads:
        fn = lambda x, ex, *g: jfield.fused_pe_nerf(  # noqa: E731
            x, ex, s, *g, F, False, 128, interpret, 3, 128)
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(extras),
                         *[to_jax(g) for g in groups])
        jg = vjp(tuple(jnp.asarray(c) for c in cots))
    else:
        fn = lambda x, *g: jfield.fused_pe_density(  # noqa: E731
            x, s, *g, F, 128, interpret, 3, 128)
        _, vjp = jax.vjp(fn, jnp.asarray(x), *[to_jax(g) for g in groups])
        jg = (lambda d, *w: (d, None, *w))(*vjp(jnp.asarray(cots[0])))
    jflat = [jg[0]] + ([jg[1]] if heads else []) + [
        w for g in jg[2:] for w in g]
    xt, ext = torch.from_numpy(x), torch.from_numpy(extras)
    tg = [to_torch(g) for g in groups]
    de = extras.shape[1] if heads else 0
    wbuf, bbuf, meta = tfield.pack_pe_field(3, F, *tg, de=de)
    if arm.name == "f32":
        wbuf = _f32_weight_buffer(tg, F, de)
    tcots = [torch.from_numpy(c) for c in cots] + [None] * (3 - len(cots))
    dx, dex, dwbuf, dbbuf = _kernel_model_pe_field_bwd(
        xt, ext if heads else None, wbuf, bbuf, meta, *tcots, False)
    grads = tfield.unpack_pe_field_grads(dwbuf, dbbuf, meta, *tg)
    got = [dx] + ([dex] if heads else []) + [g for gs in grads for g in gs]
    assert len(got) == len(jflat)
    if arm.name == "f32":
        for i, (g, r) in enumerate(zip(got, jflat)):
            assert _rel(g, r) <= 1e-4, (i, _rel(g, r))
        return
    leaves = [t.clone().requires_grad_(True)
              for t in [xt] + ([ext] if heads else []) + [w for g in tg for w in g]]
    k = 2 if heads else 1
    wl, it = [], iter(leaves[k:])
    for g in tg:
        wl.append([next(it) for _ in g])
    outs = (tfield.fused_pe_nerf_plain(leaves[0], leaves[1], *wl, F) if heads
            else (tfield.fused_pe_density_plain(leaves[0], *wl, F),))
    pgrads = torch.autograd.grad(outs, leaves, [c for c in tcots if c is not None])
    for i, (g, p, r) in enumerate(zip(got, pgrads, jflat)):
        assert _rel(g, p) <= 2e-2, (i, _rel(g, p))
        r = np.asarray(r)
        l2 = np.linalg.norm(r)
        model, plain = (np.linalg.norm(t.numpy() - r) / l2 for t in (g, p))
        assert model <= plain + 1e-2, (i, model, plain)


# the tile kernel's dynamic shared memory at [w512]'s programs, as the C
# layout function reports it on the card (PERF.md §6, the 512-wide K1 and
# K2 backward rows): the layout before the cluster ring plus its third
# barrier array (8 barriers, which moves the 128-byte-aligned ring by 128
# bytes); K1 with the heads, K2 the trunk alone (the same with and without
# dW)
W512_BWD_SMEM = {True: 223_104 + 128, False: 217_984 + 128}


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
def test_w512_bwd_tile_layout_mirror(heads):
    """``pe_plan.bwd_tile_smem`` (the mirror of fused_pe_field_bwd.cu's
    ``tile_layout``) at [w512]'s K1 and K2 backward programs: the bytes the
    C function reported with a cluster ring's barriers, three 32 KB stages
    of 512-wide slabs, over half an SM's shared memory (a block an SM, so a
    cluster of two takes two SMs); the flagship's (256 wide, no cluster
    ring) fits too."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, meta = _bwd_meta(BWD_CASES[2], heads)
    for need_dw in ((True,) if heads else (True, False)):
        plan = P.build_plan(meta, heads, True, need_dw)
        assert P.bwd_tile_smem(plan.header) == (W512_BWD_SMEM[heads], 3)
    _, _, meta = _bwd_meta(BWD_CASES[1], heads)
    total, stages = P.bwd_tile_smem(P.build_plan(meta, heads, True,
                                                 True).header)
    assert 232_448 // 2 < total <= 232_448 and stages >= 2


def test_wide_programs_split_every_product_between_warpgroups():
    """[w512]'s programs run wide (a layer over 256): every product of a
    wide program is at most 512 columns, so that each warpgroup's half is
    one wgmma shape; the relu masks take half the words a thread; layer
    0's input-gradient products take chunks up to 512; the weight-gradient
    tasks take each 512-wide G in two 256-column blocks of its slot; and
    a net at most 256 wide keeps today's program, its tasks' G whole."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    for case, wide in ((BWD_CASES[1], False), (BWD_CASES[2], True)):
        _, _, meta = _bwd_meta(case)
        fwd = P.build_forward_plan(meta, True)
        full = P.build_plan(meta, True, True, True)
        L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
        for plan in (fwd, full):
            assert P.width_class([plan.header[P.H_ACT_W]]) == wide
            assert all(op[P.O_N] <= (P.PASS_W if wide else P.MAX_N)
                       for op in plan.ops)
        widths = {op[P.O_MASK]: op[P.O_N] for op in full.ops
                  if op[P.O_KIND] == P.FWD and op[P.O_MASK] >= 0}
        words = sorted(widths)
        for w0, w1 in zip(words, words[1:] + [full.header[P.H_MASK_WORDS]]):
            assert w1 - w0 == P.mask_words(widths[w0], wide)
        assert P.mask_words(512, True) == 4 and P.mask_words(512, False) == 8
        blocks = {}
        for t in full.tasks:
            blocks.setdefault((t[P.T_W_OFF], t[P.T_W_ROW0]), []).append(
                (t[P.T_J0], t[P.T_BN], t[P.T_G_W]))
        for w_off, _, k, n, _ in L:
            want = ([(0, 256, 512), (256, 256, 512)] if n > P.MAX_N
                    else [(0, P.pow2_width(n), P.pow2_width(n))])
            assert blocks[(w_off, 0)] == want
    with pytest.raises(ValueError):              # a layer over 1024
        _bwd_meta((10, 1040, 4, 4, 15, 59, 64, 64, 1, 256, False))


def _bwd_meta(case, heads=True):
    _, extras, (base, top, color, sem) = _bwd_inputs(case)
    F = case[0]
    tb, tt, tc, ts = (to_torch(g) for g in (base, top, color, sem))
    if heads:
        return tfield.pack_pe_field(3, F, tb, tt, tc, ts, de=extras.shape[1])
    return tfield.pack_pe_field(3, F, tb, tt)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_pe_bwd_weight_image_holds_each_product_operand(case):
    """The wgmma weight image: each product op's B, decoded from the
    K-major core-matrix layout, is the layer's W block (forward) or the Wᵀ
    rows it produces (backward), zero-padded to the op's N."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    wbuf, _, meta = _bwd_meta(case)
    _check_weight_image(P.build_plan(meta, True, True, True), wbuf, meta)
    # a core matrix (8 rows of K, 8 columns of N) is 64 contiguous elements,
    # its rows 8 apart along N and K contiguous inside a row
    b = torch.arange(32 * 48, dtype=torch.float32).reshape(32, 48)
    flat = P.core_k_major(b)
    assert torch.equal(P.from_core_k_major(flat, 32, 48), b)
    assert torch.equal(flat[:64].reshape(8, 8), b[:8, :8].T)
    assert torch.equal(flat[64:128].reshape(8, 8), b[:8, 8:16].T)
    assert torch.equal(flat[6 * 64:7 * 64].reshape(8, 8), b[8:16, :8].T)


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk"])
def test_pe_bwd_workspace_slots_and_tasks(heads):
    """Workspace slots are disjoint; each 64-row block of a slot is one
    contiguous range (one bulk store, one bulk load); the weight-gradient
    tasks cover every weight row of every layer once, and the splits every
    block once."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, meta = _bwd_meta(BWD_CASES[0], heads)
    plan = P.build_plan(meta, heads, False, True)
    n_rows = 300
    n_pad = 384
    used = torch.zeros(P.ws_elems(plan, n_rows), dtype=torch.int32)
    rows = torch.arange(n_pad)
    for col, width in plan.slots.values():
        idx = P.ws_index(col, width, n_pad, rows, torch.arange(width))
        used[idx.reshape(-1)] += 1
        for blk in range(n_pad // P.BLOCK):
            b = idx[blk * P.BLOCK:(blk + 1) * P.BLOCK].reshape(-1)
            assert b.max() - b.min() + 1 == P.BLOCK * width == b.unique().numel()
    assert used.max() == 1
    assert used.sum() == plan.header[P.H_WS_COLS] * n_pad
    L = [meta[14 + 5 * i:19 + 5 * i] for i in range((len(meta) - 14) // 5)]
    n_layers = len(L) if heads else meta[6] + meta[7]
    covered = {}
    for t in plan.tasks:
        rows_t = range(t[P.T_W_ROW0], t[P.T_W_ROW0] + t[P.T_M_VALID])
        for r in rows_t:
            key = (t[P.T_W_OFF], r, t[P.T_J0])
            covered[key] = covered.get(key, 0) + 1
        assert 0 < t[P.T_M_VALID] <= P.DW_M and t[P.T_G_W] == P.pow2_width(t[P.T_N])
        assert t[P.T_BN] == min(t[P.T_G_W], P.MAX_N) and t[P.T_J0] % P.MAX_N == 0
    blocks = lambda n: range(0, n, P.MAX_N) if n > P.MAX_N else [0]  # noqa: E731
    for w_off, _, k, n, _ in L[:n_layers]:
        assert all(covered.get((w_off, r, j0)) == 1 for r in range(k)
                   for j0 in blocks(n))
    assert len(covered) == sum(l[2] * len(blocks(l[3])) for l in L[:n_layers])
    for n, tasks in ((1, 21), (196_608, 21), (5000, 16), (129, 0)):
        splits, per = P.dw_splits(n, tasks)
        blocks = -(-n // P.TILE) * 2
        assert (splits - 1) * per < blocks <= splits * per
    assert P.dw_splits(0, 21) == (0, 1)     # no rows: no split, no division


def test_pe_bwd_programs_ask_only_for_what_is_needed():
    """dx alone plans no workspace, no tasks and no bias sums; pass_sem adds
    the semantic head's input gradient; every mask an op reads was written
    earlier by a forward op of the same width."""
    from cropnerf_tpu_torch.ops.cuda import pe_plan as P
    _, _, meta = _bwd_meta(BWD_CASES[1], heads=False)
    dx_only = P.build_plan(meta, False, False, False)
    assert dx_only.slots == {} and dx_only.tasks == []
    assert all(op[P.O_WS] == -1 and op[P.O_BOFF] == -1 for op in dx_only.ops
               if op[P.O_KIND] in (P.EMIT, P.BWD))
    assert dx_only.header[P.H_WS_COLS] == 0 and P.ws_elems(dx_only, 1000) == 0
    full = P.build_plan(meta, False, False, True)
    assert [op[:P.O_IMG] for op in full.ops] == [op[:P.O_IMG] for op in dx_only.ops]
    _, _, hmeta = _bwd_meta(BWD_CASES[1])
    with pytest.raises(ValueError):
        P.build_plan(hmeta, True, False, False)
    without, with_sem = (P.build_plan(hmeta, True, ps, True) for ps in (False, True))
    extra = len(with_sem.ops) - len(without.ops)
    t_pad = hmeta[14 + 5 * (hmeta[6] + hmeta[7] - 1) + 3]
    assert extra == len(P.pow2_chunks(t_pad))
    assert [op[P.O_EPI] for op in with_sem.ops if op[P.O_KIND] == P.BWD].count(P.GT_ADD) == \
        2 * extra
    for plan in (without, with_sem, full, dx_only):
        written = {}
        for op in plan.ops:
            if op[P.O_KIND] == P.FWD and op[P.O_MASK] >= 0:
                written[op[P.O_MASK]] = op[P.O_N]
            elif op[P.O_KIND] == P.BWD and op[P.O_EPI] == P.G_MASKED:
                assert written[op[P.O_MASK]] == op[P.O_N]
    assert P.pow2_chunks(48) == [32, 16] and P.pow2_chunks(160) == [128, 32]
    assert P.pow2_chunks(512) == [256, 256] and P.pow2_chunks(512, 512) == [512]
    assert [P.pow2_width(n) for n in (16, 17, 48, 64, 200, 272, 512, 513,
                                      1024)] == [
        16, 32, 64, 64, 256, 512, 512, 1024, 1024]
    with pytest.raises(ValueError):             # past the widest layer
        P.pow2_width(1025)


def _warp_colsum_model(nv):
    """csrc/fused_pe_field_bwd.cu warp_colsum's lane and index algebra: for
    each lane, (column, [original value indices summed into it]) written."""
    writes = {}
    for lane in range(32):
        base, dup, count = 0, 0, nv
        for m in (4, 8, 16):
            if count >= 2:
                if lane & m:
                    base += count // 2
                count //= 2
            else:
                dup |= m
        if lane & dup:
            continue
        for i in range(count):
            idx = base + i
            col = 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1)
            writes.setdefault(col, []).append(lane)
    return writes


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_warp_colsum_writes_each_column_once(n):
    writes = _warp_colsum_model(n // 4)
    assert sorted(writes) == list(range(n))
    assert all(len(v) == 1 for v in writes.values())


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_trunk_backward_kernel_model_dx_alone_matches_full(case):
    """The dx-only program (the BayesRays pass's) gives the full program's
    dx."""
    x, _, (base, top, _, _) = _bwd_inputs(case, seed=6)
    xt = torch.from_numpy(x)
    wbuf, bbuf, meta = tfield.pack_pe_field(3, case[0], to_torch(base),
                                            to_torch(top))
    cot = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (x.shape[0], meta[10])).astype(np.float32))
    full = _kernel_model_pe_field_bwd(xt, None, wbuf, bbuf, meta, cot, None,
                                      None, False)
    alone = _kernel_model_pe_field_bwd(xt, None, wbuf, bbuf, meta, cot, None,
                                       None, False, need_dw=False)
    assert alone[2] is None and torch.equal(alone[0], full[0])


# --- K2 and K3 backward: the port's autograd against the JAX custom VJPs ---

def _grad_loss(out, lib):
    return lib.sum(lib.sin(out * 3.0))


def test_fused_pe_density_backward_matches_jax(arm):
    """The shapes of test_kernel_interpret_matches_fallback_fw_and_bw (F=4,
    H=32, N=256, the JAX kernels in interpret mode on 128-row tiles): dx
    and every weight leaf."""
    import jax
    F, H, N = 4, 32, 256
    rng = np.random.default_rng(7)
    enc = 3 * (1 + 2 * F)
    x = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    base = np_wbs(rng, [enc, H, H])
    top = np_wbs(rng, [H + enc, H, 8])
    s = jnp.asarray(jfield.pe_selector_matrix(F))

    def jloss(x, base, top):
        return _grad_loss(jfield.fused_pe_density(x, s, base, top, F, 128,
                                                  True, 3, 128), jnp)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), to_jax(base),
                                             to_jax(top))
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = [w.requires_grad_(True) for w in to_torch(base)]
    tt = [w.requires_grad_(True) for w in to_torch(top)]
    _grad_loss(tfield.fused_pe_density(xt, bt, tt, F, arm.dtype),
               torch).backward()
    tol = BWD_TOL[arm.name]
    assert_close(xt.grad, ref[0], tol, "dx")
    for name, got_g, ref_g in (("base", bt, ref[1]), ("top", tt, ref[2])):
        for i, (w, r) in enumerate(zip(got_g, ref_g)):
            assert_close(w.grad, r, tol, f"{name} {i}")


# (dims, N, JAX tile): the shapes of tests/test_pallas.py's backward test
# (a grid of two tiles), the vanilla field's two heads, and a 3-layer MLP on
# the JAX kernel (N=128) and on the JAX ragged path (N=127, autodiff of the
# forward's jnp mirror).  At 3 layers the JAX kernel recomputes hidden layer
# 2 from the float32 relu output where its forward rounds it to bf16 first;
# the port follows the forward, as the ragged path does (they agree to 0 in
# the bf16 arm).  A relu unit near zero then takes the other side in a few
# elements, so the bf16 arm holds the kernel case against the largest value:
# |port - JAX| <= 5e-2 · max |JAX|, the rtol of JAX's own test (measured
# 3.5e-2 for dx, 1.3e-2 for the weights).
MLP_BWD_CASES = {"jax-test": ((16, 32, 8), 128, 64),
                 "semantic-head": ((15, 64, 1), 256, 128),
                 "colour-head": ((74, 64, 3), 256, 128),
                 "3-layer": ((16, 32, 32, 8), 128, 64),
                 "3-layer-ragged": ((16, 32, 32, 8), 127, 64)}


@pytest.mark.parametrize("case", list(MLP_BWD_CASES))
def test_fused_mlp_backward_matches_jax(case, arm):
    import jax
    dims, n, tile = MLP_BWD_CASES[case]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    wbs = np_wbs(rng, dims)
    ref = jax.grad(lambda x, w: _grad_loss(jax_fused_mlp(x, w, tile, True),
                                           jnp), argnums=(0, 1))(
        jnp.asarray(x), to_jax(wbs))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [w.requires_grad_(True) for w in to_torch(wbs)]
    _grad_loss(tmlp.fused_mlp(xt, wt, arm.dtype), torch).backward()
    tol = BWD_TOL[arm.name]
    for name, g, r in [("dx", xt.grad, ref[0])] + [
            (f"wbs {i}", w.grad, r) for i, (w, r) in enumerate(zip(wt, ref[1]))]:
        if case == "3-layer" and arm.name == "bf16":
            r = np.asarray(r)
            err = np.abs(g.numpy() - r).max() / np.abs(r).max()
            assert err <= 5e-2, (name, err)
        else:
            assert_close(g, r, tol, name)


def _kernel_model_mlp_bwd(x, wbuf, bbuf, meta, g, need_dw=True):
    """The MLP backward's arithmetic in torch, on pack_layers' buffers (the
    layout the stream route's weight gradients come back in): the bf16
    recompute A_l kept per layer, then per layer the weight gradient
    A_lᵀ·G_l of bf16 operands, G_{l-1} = relu mask of A_l (bf16(G_l) Wᵀ) in
    f32 for the bias sums and bf16 for the next product, and dx."""
    din, din_pad, dout, n_layers, _ = meta[:5]
    L = [meta[5 + 5 * i:10 + 5 * i] for i in range(n_layers)]
    N = x.shape[0]
    a = torch.zeros((N, din_pad))
    a[:, :din] = x
    acts = [a.bfloat16()]
    for l in range(n_layers - 1):
        acts.append(torch.relu(_kernel_layer(acts[l], acts[l], wbuf, bbuf,
                                             L[l])).bfloat16())
    gl = torch.zeros((N, L[-1][3]))
    gl[:, :dout] = g
    dwbuf, dbbuf = torch.zeros(wbuf.shape), torch.zeros(bbuf.shape)
    dbbuf[L[-1][1]:L[-1][1] + L[-1][3]] = gl.sum(0)
    gcur = gl.bfloat16()
    for l in range(n_layers - 1, -1, -1):
        w_off, b_off, k, n, _ = L[l]
        if need_dw:
            dwbuf[w_off:w_off + k * n] = (acts[l].float().T
                                          @ gcur.float()).reshape(-1)
        w = wbuf[w_off:w_off + k * n].reshape(k, n).float()
        v = gcur.float() @ w.T
        if l == 0:
            return v[:, :din], dwbuf, dbbuf
        v = torch.where(acts[l].float() > 0, v, 0.0)
        dbbuf[L[l - 1][1]:L[l - 1][1] + L[l - 1][3]] = v.sum(0)
        gcur = v.bfloat16()


@pytest.mark.parametrize("case", list(MLP_BWD_CASES))
def test_mlp_backward_kernel_model_reproduces_plain_autograd(case):
    dims, n, _ = MLP_BWD_CASES[case]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((n, dims[0]))
                         .astype(np.float32)).requires_grad_(True)
    wt = [w.requires_grad_(True) for w in to_torch(np_wbs(rng, dims))]
    out = tmlp.fused_mlp_plain(x, wt)
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, [x, *wt], cot)
    with torch.no_grad():
        wbuf, bbuf, descs = pack_layers(tmlp._layers(wt), torch.device("cpu"))
        meta = [dims[0], pad16(dims[0]), dims[-1], len(dims) - 1, 0] + descs
        dx, dwbuf, dbbuf = _kernel_model_mlp_bwd(x, wbuf, bbuf, meta, cot)
        grads = [t for ws, db in tmlp.unpack_layers(tmlp._layers(wt), dwbuf,
                                                    dbbuf, meta[5:])
                 for t in (*ws, db)]
    for i, (g, r) in enumerate(zip([dx] + grads, ref)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = ((g - r).abs().max() / r.abs().max().clamp_min(1e-6)).item()
        assert err <= 2e-2, (i, err)


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_trunk_backward_kernel_model_reproduces_plain_autograd(case):
    """The backward kernel without heads (fused_pe_density's backward):
    the same three passes on the trunk alone."""
    x, _, (base, top, _, _) = _bwd_inputs(case, seed=6)
    F = case[0]
    rng = np.random.default_rng(10)
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = [w.requires_grad_(True) for w in to_torch(base)]
    tt = [w.requires_grad_(True) for w in to_torch(top)]
    out = tfield.fused_pe_density_plain(xt, bt, tt, F)
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    ref = torch.autograd.grad(out, [xt, *bt, *tt], cot)
    with torch.no_grad():
        wbuf, bbuf, meta = tfield.pack_pe_field(3, F, bt, tt)
        dx, dex, dwbuf, dbbuf = _kernel_model_pe_field_bwd(
            xt, None, wbuf, bbuf, meta, cot, None, None, False)
        d_base, d_top, d_color, d_sem = tfield.unpack_pe_field_grads(
            dwbuf, dbbuf, meta, bt, tt)
    assert dex is None and d_color == [] and d_sem == []
    for i, (g, r) in enumerate(zip([dx, *d_base, *d_top], ref)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        err = ((g - r).abs().max() / r.abs().max().clamp_min(1e-6)).item()
        assert err <= 2e-2, (i, err)
