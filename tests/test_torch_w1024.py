"""[w1024]: the PE field's kernels (K1 ``fused_pe_nerf``, K2
``fused_pe_density``) at a 1024-wide trunk, the port against the JAX
package on the CPU.

A trunk over 512 wide puts the kernels' programs in width class 2
(``ops/cuda/pe_plan.py``): both warpgroups on one 64-row tile, a 1024-wide
product in two passes of 512 columns, the first pass's output held until
the second has read the tile, the backward's relu masks in device memory.
The kernels run only on the card (tests/test_torch_gpu.py); here the plain
paths run against JAX's (its jnp mirrors: the Pallas kernels' reference
path), the programs run op by op in torch (the models of
tests/test_torch_kernels.py, and ``_pass_model_pe_field_fwd``, the forward
as class 2's tile runs it), the layouts against the C layout functions'
mirrors, and the [w1024] model's forward and training step against JAX's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas import fused_pe_field as jfield
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
from cropnerf_tpu_torch.ops.cuda import mlp_plan as mp
from cropnerf_tpu_torch.ops.cuda import pe_plan as P
from test_torch_kernels import (BWD_TOL, _bwd_inputs, _fwd_case,
                                _kernel_model_pe_field_bwd,
                                _kernel_model_pe_field_fwd, _check_weight_image,
                                _rel)
from torch_parity import arm, assert_close, np_wbs, to_jax, to_torch  # noqa: F401

W1024 = 1024
# (num_freqs, hidden, n_base, n_top, G, De, Hc, Hs, N) as PE_CASES, and
# (..., Hs, C, N, interpret) as BWD_CASES: [w1024]'s field (cropnerf-mxu's
# with a 1024-wide trunk; 64-wide heads) at 64 rows, the trunk cut to two
# base and two top layers (a 1024 x 1024 product, the skip layer, t); the
# layouts take the full 4 + 4 (W1024_FULL)
PE_W1024 = (10, W1024, 2, 2, 15, 59, 64, 64, 64)
W1024_FULL = (10, W1024, 4, 4, 15, 59, 64, 64, 64)
BWD_W1024 = (10, W1024, 2, 2, 15, 59, 64, 64, 1, 64, False)
# bf16 gradients of the plain path against JAX's, in relative L2: at 1024
# wide a few bf16 activations round to the other neighbour in the two
# frameworks (a relu kink) and move their rows' gradients, 4 of 192 dx
# entries past BWD_TOL's elementwise 5e-2 and 4.6e-2 of max on a top
# layer's weights (measured); their relative L2 is at most 1.2e-2 (K1 and
# K2, measured), so they are held in relative L2 to 2e-2, the [w512]
# programs' bf16 gradient bound (test_backward_kernel_model_matches_jax)
BWD_L2_1024_BF16 = 2e-2


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
def test_plain_paths_match_jax_at_1024(heads, arm):
    """The port's CPU path of K1 (trunk and heads) and K2 (the trunk) at
    [w1024]'s field, forward and VJP, against JAX's on the CPU (its jnp
    mirrors ``_mega_ref`` and ``_ref_forward``): the outputs to the arm's
    tolerance, the float32 gradients to BWD_TOL, the bf16 ones in relative
    L2 to BWD_L2_1024_BF16."""
    x, extras, groups = _bwd_inputs(BWD_W1024)
    F = BWD_W1024[0]
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    rng = np.random.default_rng(7)
    cols = [groups[1][-2].shape[1]] + ([3, 1] if heads else [])
    cots = [rng.standard_normal((x.shape[0], c)).astype(np.float32)
            for c in cols]
    if heads:
        fn = lambda x, ex, *g: jfield.fused_pe_nerf(  # noqa: E731
            x, ex, s, *g, F, False, 128, False, 3, 128)
        args, jcots = (x, extras), tuple(jnp.asarray(c) for c in cots)
    else:
        fn = lambda x, *g: jfield.fused_pe_density(  # noqa: E731
            x, s, *g, F, 128, False, 3, 128)
        args, jcots = (x,), jnp.asarray(cots[0])

    @jax.jit                                   # one compile: forward and VJP
    def run(args, groups, jcots):
        out, vjp = jax.vjp(fn, *args, *groups)
        return out, vjp(jcots)

    ref, jg = run(tuple(jnp.asarray(a) for a in args),
                  [to_jax(g) for g in (groups if heads else groups[:2])], jcots)
    ref = ref if heads else (ref,)
    xt = torch.from_numpy(x).requires_grad_(True)
    ext = torch.from_numpy(extras).requires_grad_(True)
    tg = [[w.requires_grad_(True) for w in to_torch(g)]
          for g in (groups if heads else groups[:2])]
    if heads:
        got = tfield.fused_pe_nerf(xt, ext, *tg, F, arm.dtype)
        leaves = [xt, ext]
    else:
        got = (tfield.fused_pe_density(xt, *tg, F, arm.dtype),)
        leaves = [xt]
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert_close(g.detach(), r, arm.tol, name)
    flat = [w for g in tg for w in g]
    grads = torch.autograd.grad(got, leaves + flat,
                                [torch.from_numpy(c) for c in cots])
    jflat = list(jg[:len(leaves)]) + [w for g in jg[len(leaves):] for w in g]
    assert len(grads) == len(jflat)
    for i, (g, r) in enumerate(zip(grads, jflat)):
        if arm.name == "f32":
            assert_close(g, r, BWD_TOL["f32"], f"gradient {i}")
        else:
            r = np.asarray(r)
            l2 = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), 1e-12)
            assert l2 <= BWD_L2_1024_BF16, (i, l2)


def _pass_model_pe_field_fwd(x, extras, wbuf, bbuf, meta, heads):
    """csrc/fused_pe_field.cu's forward in class 2 as its block runs it:
    one copy of the rows' encoding, activation and t tiles shared by both
    warpgroups; a product up to 512 wide splits its columns between them
    (warpgroup w the slabs' [w N/2, (w + 1) N/2)); a 1024-wide product
    takes two passes, each from its pass image (``pe_plan.pass_columns``),
    warpgroup w's columns [512w + 256q, +256) in pass q, the first pass's
    relu'd bf16 held until the second has read the tile.  Returns t, or
    (t, rgb_raw, sem_raw) with the heads."""
    cd = wbuf.dtype
    plan = P.build_forward_plan(meta, heads)
    img = P.weight_image(wbuf, P.image_index(meta, plan))
    h = plan.header
    assert P.width_class([h[P.H_ACT_W]]) == 2
    N = x.shape[0]
    n_pad = -(-N // P.BLOCK) * P.BLOCK
    xs, exs = torch.zeros((n_pad, h[P.H_DIM])), torch.zeros((n_pad, h[P.H_ACT_W]))
    xs[:N] = x
    if heads:
        exs[:N, :extras.shape[1]] = extras
    enc = torch.zeros((n_pad, h[P.H_ENC_PAD]))
    enc[:, :h[P.H_ENC_COLS]] = tfield._encode(xs, h[P.H_FREQS])
    bufs = {P.ENC: enc.to(cd),
            P.ACT: torch.full((n_pad, h[P.H_ACT_W]), float("nan")).to(cd),
            P.TB: torch.zeros((n_pad, h[P.H_TB_W]), dtype=cd)}
    cols = {P.T_OUT: h[P.H_T_COLS], P.RGB_OUT: h[P.H_RGB_COLS],
            P.SEM_OUT: h[P.H_SEM_COLS]}
    outs = {}
    for op in plan.ops:
        n, K, ka = op[P.O_N], op[P.O_K], op[P.O_KA]
        if op[P.O_KIND] == P.EX:
            bufs[P.ACT][:, :n] = exs[:, :n].to(cd)
            continue
        a = torch.cat([bufs[op[P.O_A0]][:, :ka], bufs[op[P.O_A1]][:, :K - ka]], 1)
        at, epi, nv = op[P.O_IMG], op[P.O_EPI], op[P.O_NVALID]
        bias = torch.zeros(n)
        bias[:nv] = bbuf[op[P.O_BOFF]:op[P.O_BOFF] + nv]
        if n > P.PASS_W:                       # two passes of both warpgroups
            assert epi == P.RELU and n == 2 * P.PASS_W
            parked = {}
            for q in range(2):
                b = P.from_core_k_major(img[at + q * K * P.PASS_W:
                                            at + (q + 1) * K * P.PASS_W],
                                        K, P.PASS_W)
                for w in range(2):
                    c = torch.arange(w * 512 + q * 256, w * 512 + q * 256 + 256)
                    acc = a.float() @ b[:, w * 256:(w + 1) * 256].float()
                    parked[(q, w)] = (c, torch.relu(acc + bias[c]).to(cd))
            for c, v in parked.values():       # both passes read, then stored
                bufs[P.ACT][:, c] = v
            continue
        b = P.from_core_k_major(img[at:at + K * n], K, n)
        half, accs = n // 2, []
        for w in range(2):
            c = torch.arange(w * half, (w + 1) * half)
            accs.append((c, a.float() @ b[:, c].float() + bias[c]))
        for c, acc in accs:
            if epi in (P.RELU, P.T_OUT):
                v = (torch.relu(acc) if epi == P.RELU else acc).to(cd)
                bufs[P.ACT if epi == P.RELU else P.TB][:, c] = v
            if epi in cols:
                out = outs.setdefault(epi, torch.full((n_pad, cols[epi]), float("nan")))
                live = c < cols[epi]
                out[:, c[live]] = acc[:, live]
    got = [outs[e][:N] for e in ((P.T_OUT, P.RGB_OUT, P.SEM_OUT) if heads
                                 else (P.T_OUT,))]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return tuple(got) if heads else got[0]


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
def test_pass_model_reproduces_plain_path(heads):
    """[w1024]'s forward program as class 2's tile runs it
    (``_pass_model_pe_field_fwd``) on a float32 weight image gives the
    float32 plain version's outputs to 1e-5 of their largest value, and
    the whole program's (``_kernel_model_pe_field_fwd``) bit for bit in
    bf16: each column's sum is the same sum, in the same k order, whichever
    pass and warpgroup takes it."""
    F = PE_W1024[0]
    x, ex, groups, (wbuf, bbuf, meta) = _fwd_case(PE_W1024, heads,
                                                  torch.float32)
    assert meta[13] == W1024
    got = _pass_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    if heads:
        ref = tfield.fused_pe_nerf_plain(x, ex, *groups, F, torch.float32)
    else:
        got = (got,)
        ref = (tfield.fused_pe_density_plain(x, *groups, F, torch.float32),)
    for name, g, r in zip(("t", "rgb_raw", "sem_raw"), got, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))
    x, ex, _, (wbuf, bbuf, meta) = _fwd_case(PE_W1024, heads)
    passes = _pass_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    whole = _kernel_model_pe_field_fwd(x, ex, wbuf, bbuf, meta, heads)
    for g, w in zip(passes if heads else (passes,), whole if heads else (whole,)):
        assert torch.equal(g, w), float((g - w).abs().max())


def test_backward_program_reproduces_plain_autograd_at_1024():
    """K1's backward program at [w1024]'s field (``_kernel_model_pe_field_bwd``:
    the tile program op by op on the pass images, the relu masks, the
    workspace and the weight-gradient tasks with 1024-wide G slots in
    256-column blocks) on a float32 image against float32 autograd of the
    plain version, dx, dextras and every weight and bias gradient to 1e-5
    of its largest value (measured 6.4e-7: the same sums in another order).
    The plain version is held to JAX's VJP by
    test_plain_paths_match_jax_at_1024; the two differ at 1024 wide by a
    relu kink or two in float32 too (one row of 64 at this seed: 4.2e-3 of
    max on dx, 3.2e-2 on a weight), so the program is held to the plain
    version, as the [w512] programs' bf16 gradients are."""
    from test_torch_kernels import _f32_weight_buffer
    x, extras, groups = _bwd_inputs(BWD_W1024, seed=12)
    F = BWD_W1024[0]
    rng = np.random.default_rng(13)
    cots = [torch.from_numpy(rng.standard_normal((x.shape[0], c))
                             .astype(np.float32)) for c in (16, 3, 1)]
    tg = [to_torch(g) for g in groups]
    _, bbuf, meta = tfield.pack_pe_field(3, F, *tg, de=extras.shape[1])
    wbuf = _f32_weight_buffer(tg, F, extras.shape[1])
    xt, ext = torch.from_numpy(x), torch.from_numpy(extras)
    dx, dex, dwbuf, dbbuf = _kernel_model_pe_field_bwd(
        xt, ext, wbuf, bbuf, meta, *cots, False)
    grads = tfield.unpack_pe_field_grads(dwbuf, dbbuf, meta, *tg)
    got = [dx, dex] + [g for gs in grads for g in gs]
    leaves = [t.clone().requires_grad_(True)
              for t in [xt, ext] + [w for g in tg for w in g]]
    it = iter(leaves[2:])
    wl = [[next(it) for _ in g] for g in tg]
    outs = tfield.fused_pe_nerf_plain(leaves[0], leaves[1], *wl, F,
                                      torch.float32)
    ref = torch.autograd.grad(outs, leaves, cots)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and _rel(g, r) <= 1e-5, (i, _rel(g, r))


def _w1024_meta(heads, case=PE_W1024):
    _, _, _, (wbuf, _, meta) = _fwd_case(case, heads)
    return wbuf, meta


# the kernels' dynamic shared memory and ring stages at [w1024]'s programs
# (the C layout functions, fwd_layout and tile_layout, report the same on
# the card: tests/test_torch_gpu.py): the forward one 64-row region (the
# encoding and output stage, t, the 64 x 1024 activation tile), the ops,
# two 32 KB stages of 512-wide slabs; the backward its one region (x, the
# encoding, t and its cotangent under the encoding's f32 cotangent, the
# activation tile, both warpgroups' column sums) and a cluster ring of two
# 32 KB stages, its relu masks in device memory
W1024_SMEM = {("fwd", True): (207_872, 2), ("fwd", False): (207_616, 2),
              ("bwd", True): (222_208, 2), ("bwd", False): (222_208, 2)}


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
def test_w1024_layouts_fit_and_mirror(heads):
    """``pe_plan.fwd_smem`` and ``bwd_tile_smem`` at [w1024]'s K1 and K2
    programs fit a block's shared memory with the stages their kernels
    need, and give the bytes the layouts above add up to; the backward's
    relu masks take 8 words a thread for each 1024-wide hidden layer (in
    device memory); the forward's scratch holds a block's 64 words a
    thread for each SM, and none below class 2."""
    _, meta = _w1024_meta(heads, W1024_FULL)
    fwd = P.build_forward_plan(meta, heads)
    total, stages = P.fwd_smem(fwd.header)
    assert total <= tfield.MAX_SMEM_BYTES and stages >= P.PASS_MIN_STAGES
    assert (total, stages) == W1024_SMEM[("fwd", heads)]
    region = (P.al128(max(P.BLOCK * 64 * 2, P.BLOCK * 16 * 4))
              + P.al128(P.BLOCK * 16 * 2) + P.al128(P.BLOCK * W1024 * 2))
    ops = P.al128(len(fwd.ops) * P.OP_INTS * 4)
    assert total == P.al128(region + ops + 16 + 2 * 8 * 8) + 2 * 32 * 512 * 2
    for need_dw in ((True,) if heads else (True, False)):
        plan = P.build_plan(meta, heads, False, need_dw)
        assert P.bwd_tile_smem(plan.header) == W1024_SMEM[("bwd", heads)]
        hidden = [op for op in plan.ops
                  if op[P.O_KIND] == P.FWD and op[P.O_MASK] >= 0]
        assert plan.header[P.H_MASK_WORDS] == sum(
            P.mask_words(op[P.O_N], 2) for op in hidden)
        assert P.mask_words(W1024, 2) == 8
    # the forward's scratch: 64 words a consumer thread for each SM
    assert P.fwd_park_elems(fwd.header, 132) == 132 * 64 * 256
    _, _, _, (_, _, meta512) = _fwd_case((10, 512, 4, 4, 15, 59, 64, 512, 64),
                                         heads)
    assert P.fwd_park_elems(P.build_forward_plan(meta512, heads).header,
                            132) == 0


@pytest.mark.parametrize("heads", [True, False], ids=["K1", "K2"])
def test_w1024_programs_take_two_passes(heads):
    """[w1024]'s programs are class 2: every 1024-wide product is a hidden
    layer's (the forward's and the recompute's RELU, the backward's
    G_MASKED) and its weight image holds its two passes, each pass's
    columns ``pass_columns`` (warpgroup 0's 256, then warpgroup 1's) as a
    [K, 512] image, together every column once; every other product is at
    most 512 wide; the weight-gradient tasks take each 1024-wide G in four
    256-column blocks; each op's B decodes to its layer's W (forward) or
    Wᵀ rows (backward)."""
    wbuf, meta = _w1024_meta(heads)
    for plan in (P.build_forward_plan(meta, heads),
                 P.build_plan(meta, heads, False, True)):
        assert P.width_class([plan.header[P.H_ACT_W]]) == 2
        for op in plan.ops:
            if op[P.O_N] > P.PASS_W:
                assert op[P.O_N] == W1024 and (
                    (op[P.O_KIND] == P.FWD and op[P.O_EPI] == P.RELU)
                    or (op[P.O_KIND] == P.BWD and op[P.O_EPI] == P.G_MASKED))
        _check_weight_image(plan, wbuf, meta)
    cols = P.pass_columns(W1024)
    assert len(cols) == 2 and sorted(c for q in cols for c in q) == list(range(W1024))
    assert cols[0][:2] == [0, 1] and cols[0][256] == 512 and cols[1][0] == 256
    b = torch.arange(32 * W1024, dtype=torch.float32).reshape(32, W1024)
    assert torch.equal(P.from_pass_image(P.pass_image(b), 32, W1024), b)
    plan = P.build_plan(meta, heads, False, True)
    blocks = {}
    for t in plan.tasks:
        if t[P.T_G_W] == W1024:
            blocks.setdefault((t[P.T_W_OFF], t[P.T_W_ROW0]), []).append(t[P.T_J0])
    assert blocks and all(j == [0, 256, 512, 768] for j in blocks.values())


def test_refusals_name_their_width():
    """On the card K1 and K2 take layers up to 1024 and raise past it
    (``pack_pe_field``), naming the width; their output layers stay at
    most 512 (the plan raises); the stream route (K3's and K5's nets)
    still refuses a layer over 512 with its message unchanged."""
    rng = np.random.default_rng(0)
    x = torch.zeros((4, 3))
    for H, fine in ((1024, True), (1040, False)):
        base = to_torch(np_wbs(rng, [63, H, H]))
        top = to_torch(np_wbs(rng, [H + 63, H, 16]))
        if fine:
            meta = tfield.pack_pe_field(3, 10, base, top)[2]
            assert P.width_class([P.build_forward_plan(meta, False).header[
                P.H_ACT_W]]) == 2
        else:
            with pytest.raises(ValueError, match="1040"):
                tfield.pack_pe_field(3, 10, base, top)
        # the CPU path takes any width, as JAX does
        assert tfield.fused_pe_density(x, base, top, 10).shape == (4, 16)
    base = to_torch(np_wbs(rng, [63, 64, 64]))
    top = to_torch(np_wbs(rng, [64 + 63, 64, 600]))
    meta = tfield.pack_pe_field(3, 10, base, top)[2]
    with pytest.raises(ValueError, match="608 padded columns"):
        P.build_forward_plan(meta, False)
    with pytest.raises(ValueError, match="at most 512 wide"):
        tmlp.fused_mlp_route(15, [1024, 1])
    with pytest.raises(ValueError, match="each at most 512 wide"):
        tfield.pe_mlp_fwd_route(3, 5, [1024, 1024, 1024, 1])
    with pytest.raises(ValueError, match="at most 512 wide"):
        mp.build_stream_plan(15, [520, 1], backward=False)
    assert not mp.stream_takes(15, [513, 1]) and mp.stream_takes(15, [512, 1])


# --- the [w1024] model against JAX's ----------------------------------------

def w1024(presets, **changes):
    """``[w1024]``, reduced: ``cropnerf-mxu`` with a 1024-wide trunk
    (``field.hidden_dim``; its 64-wide colour and semantic heads) and, as
    mip-NeRF 360's proposal MLPs, both PE proposal nets fused, 4 layers 256
    wide (``dataclasses.replace``, as ``benchmarks/ab_propshape.py`` builds
    its arms), with few rays and samples (``test_torch_propfused.propfused``)."""
    from test_torch_propfused import propfused
    cfg = propfused(presets, "cropnerf-mxu", **changes)
    m = cfg.model
    m = dataclasses.replace(
        m, field=dataclasses.replace(m.field, hidden_dim=W1024),
        proposal_fields=tuple(dataclasses.replace(p, hidden_dim=256,
                                                  num_layers=4)
                              for p in m.proposal_fields))
    return dataclasses.replace(cfg, model=m)


@pytest.mark.parametrize("arm", ["f32"], indirect=True)
def test_w1024_forward_and_train_step_match_jax(arm, monkeypatch):
    """[w1024]'s ``forward`` on 32 rays and one training step on 32 rays
    against JAX's, from the same parameters (JAX's ``model_init``, carried
    over by ``convert.params_from_jax``), in the float32 arm: the forward's
    outputs to the arm's tolerance; the step's loss, terms, every gradient
    leaf and the rays' gradients as [w512]'s step (every leaf behind a relu
    unit to Q_KINK_TOL).  On the card this path runs K1 forward and
    backward in class 2 and both proposal nets on the stream route."""
    from cropnerf_tpu.core.rays import RayBundle as JaxRays
    from cropnerf_tpu.models.config import PRESETS as JAX_PRESETS
    from cropnerf_tpu.models.model import forward as jax_forward
    from cropnerf_tpu_torch.core.rays import RayBundle
    from cropnerf_tpu_torch.models.config import PRESETS as TORCH_PRESETS
    from cropnerf_tpu_torch.models.model import forward
    from test_torch_propfused_wide import Q_KINK_TOL, _q_kinked
    from test_torch_train import RAYS, STEP, check_train_step
    from torch_parity import jax_and_torch_params
    jcfg, tcfg = (w1024(p, train_num_rays_per_batch=RAYS)
                  for p in (JAX_PRESETS, TORCH_PRESETS))
    f = tcfg.model.field
    assert (f.hidden_dim, f.hidden_dim_semantics, f.hidden_dim_color,
            f.mlp_impl) == (W1024, 64, 64, "pallas-fused")
    for p in tcfg.model.proposal_fields:
        widths = [p.hidden_dim] * (p.num_layers - 1) + [1]
        assert tfield.pe_mlp_fwd_route(3, p.pe_freqs, widths) == "stream"
    params, tp = jax_and_torch_params(jcfg.model, num_images=2)
    rng = np.random.default_rng(3)
    n = 32
    d = rng.standard_normal((n, 3)).astype(np.float32)
    rays = dict(origins=(rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32),
                directions=d / np.linalg.norm(d, axis=1, keepdims=True),
                nears=np.full((n,), 0.05, np.float32),
                fars=np.full((n,), 2.0, np.float32),
                camera_idx=rng.integers(0, 2, (n,)).astype(np.int32))
    ref = jax.jit(lambda p, r: jax_forward(p, r, jcfg.model, key=None,
                                           train=False))(
        params, JaxRays(**{k: jnp.asarray(v) for k, v in rays.items()}))
    got = forward(tp, RayBundle(**{k: torch.from_numpy(v)
                                   for k, v in rays.items()}),
                  tcfg.model, compute_dtype=arm.dtype)
    for k in ("rgb", "accumulation", "depth", "semantics"):
        assert_close(got[k], ref[k], arm.tol, k)
    check_train_step(jcfg, tcfg, STEP, arm, monkeypatch, _q_kinked,
                     Q_KINK_TOL)
