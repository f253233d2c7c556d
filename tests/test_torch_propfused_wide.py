"""K5's wide route (``fused_pe_mlp`` at hidden widths over 64) and the
``cropnerf-mxu-q`` path with both 128-wide PE proposal nets on it, against
the JAX package on the CPU.

A CPU model of the route's kernels (the PE variants of
``csrc/fused_mlp_fwd.cu`` and ``csrc/fused_mlp_bwd.cu``) on their own
weight images, forward and backward, against autograd of the plain
version and the JAX VJP; then the slice as a whole: one training step,
the render and the depth cloud's batch of ``cropnerf-mxu-q`` with fused
proposals, at full widths with few samples (``test_torch_propfused.py``'s
``propfused``), against JAX, which runs its kernel as its own tests run it
(interpret mode on 128-row tiles, or the jnp path).  The kernel-level
comparison of the wide nets against JAX is ``test_torch_propfused.py``'s
``test_fused_pe_mlp_matches_jax`` (its q cases).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas import fused_pe_field as jfield
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
from test_torch_propfused import (Q_WIDTHS, _check_forward_and_depth_batch,
                                  _check_render, _check_train_step,
                                  _pe_encoding)
from torch_parity import (arm, assert_close, np_wbs, to_jax,  # noqa: F401
                          to_torch)


def _wide_kernel_model(x, wbs, F, g, sm_count):
    """The "wide" route's kernels (the PE variant of csrc/fused_mlp_fwd.cu,
    and with weight gradients csrc/fused_pe_mlp_wide_bwd.cu) in torch, on
    the weight images ``pe_mlp_images`` builds for the net
    (``fused_mlp.mlp_images``' layout: the encoding's rows padded to 16,
    hidden layers to 128 or 256), read back as their wgmma operands index
    them (test_torch_fused_mlp ``_operands``; the backward's G·Wᵀ reads
    the forward images, the same values): the encoding rounded to bf16 as
    layer 0's input, the heads' kernels' forward and recompute, and per
    64-row tile going back through the layers the input gradient G·Wᵀ, the
    relu mask of the bf16 activation and the bias gradients' f32 column
    sums.  The weight gradients follow the backward's plan: block b of
    ``pe_mlp_blocks(N, sm_count, 1)`` takes tiles b, b + blocks, ... in
    order, and its f32 sums of bf16 operands take each tile's products a
    16-row k-step at a time (its wgmma chain), kept across its tiles and
    written once into its partial row; the rows summed in block order.  dx
    from layer 0's f32 input gradient times d(encode)/d(pre)·2^f, summed
    per coordinate in column order.  Returns (out, dx, [dW0, db0, ...])."""
    from test_torch_fused_mlp import OW, _operands
    N, dim = x.shape
    din, dout, n_layers = dim * (1 + 2 * F), wbs[-2].shape[1], len(wbs) // 2
    enc, coord, freq, pre, sin_end = _pe_encoding(x, F)
    col = torch.arange(din)
    fw, bw, bias, offs, widths, hw = _operands(wbs)
    b_at = [l * hw for l in range(n_layers)]
    a = torch.zeros((N, fw[0].shape[0]))
    a[:, :din] = enc
    acts = [a.bfloat16().float()]
    for l in range(n_layers - 1):
        acts.append(torch.relu(acts[l] @ fw[l] + bias[b_at[l]:b_at[l] + hw])
                    .bfloat16().float())
    out = (acts[-1] @ fw[-1] + bias[b_at[-1]:b_at[-1] + OW])[:, :dout]
    gl = torch.zeros((N, OW))
    gl[:, :dout] = g
    deriv = torch.where(col < dim, torch.ones(din),
                        torch.where(col < sin_end, torch.cos(pre),
                                    -torch.sin(pre)) * freq)
    blocks = tfield.pe_mlp_blocks(N, sm_count, 1)
    # each block's sums over its tiles, its partial row once written
    rows = torch.zeros((blocks, sum(f.numel() for f in fw)))
    db = torch.zeros(bias.numel())
    dx = torch.zeros((N, dim))
    for t in range(-(-N // 64)):                  # block t % blocks, in order
        r = slice(64 * t, min(64 * t + 64, N))
        acc = rows[t % blocks]
        gcur = gl[r]
        db[b_at[-1]:b_at[-1] + OW] += gcur.sum(0)
        for l in range(n_layers - 1, -1, -1):
            gb = gcur.bfloat16().float()
            a_l = acts[l][r]
            for k in range(0, a_l.shape[0], 16):  # the k-steps of the chain
                grad_w = (a_l[k:k + 16].T @ gb[k:k + 16] if l else
                          (gb[k:k + 16].T @ a_l[k:k + 16]).T)
                acc[offs[l]:offs[l] + grad_w.numel()] += grad_w.reshape(-1)
            v = gb @ bw[l].T
            if l:
                gcur = torch.where(acts[l][r] > 0, v, 0.0)
                db[b_at[l - 1]:b_at[l - 1] + hw] += gcur.sum(0)
        d_pre = v[:, :din] * deriv[r]
        for c in range(din):                      # column order, per coordinate
            dx[r, coord[c]] += d_pre[:, c]
    dw = torch.zeros(rows.shape[1])
    for row in rows:                              # the rows' sums in order
        dw += row
    return out, dx, tmlp.unpack_images_grads(wbs, dw, db)


# (num_freqs, widths, N): cropnerf-mxu-q's nets (JAX's kernel in interpret
# mode at 384 rows; at 300, no tile divisor, its jnp path), and a 2-layer
# net 256 wide
WIDE_MODEL_CASES = {"q-net0": (5, Q_WIDTHS[5], 384),
                    "q-net1-ragged": (6, Q_WIDTHS[6], 300),
                    "two-layers-256": (5, [33, 256, 1], 256)}


@pytest.mark.parametrize("case", list(WIDE_MODEL_CASES))
def test_wide_kernel_model_reproduces_plain(case):
    """The wide route's kernels' model against autograd through the plain
    version (the same roundings: 1e-2 of max) and against the JAX VJP of
    fused_pe_mlp: the output to 2e-2 of max, dx row by row (2e-2 of max
    on 98 % of rows) and every gradient to 5e-2 in relative L2, the card's
    gradient tolerance; the rows spread over 2 blocks, their weight
    gradients in two partial rows."""
    F, dims, n = WIDE_MODEL_CASES[case]
    assert tfield.pe_mlp_fwd_route(3, F, dims[1:]) == "wide"
    rng = np.random.default_rng(70 + n)
    xn = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    wn = np_wbs(rng, dims)
    cot = rng.standard_normal((n, 1)).astype(np.float32)
    s = jnp.asarray(jfield.pe_selector_matrix(F))
    ref_out, vjp = jax.vjp(lambda x, w: jfield.fused_pe_mlp(
        x, s, w, F, 128, True, 3, 128), jnp.asarray(xn), to_jax(wn))
    jdx, jdw = vjp(jnp.asarray(cot))
    x, wt = torch.from_numpy(xn), to_torch(wn)
    img, bias = tfield.pe_mlp_images(wt)
    want = tmlp.mlp_images(wt)
    assert torch.equal(img, want[0]) and torch.equal(bias, want[1])
    leaves = [t.clone().requires_grad_(True) for t in (x, *wt)]
    plain_out = tfield.fused_pe_mlp_plain(leaves[0], leaves[1:], F)
    plain_grads = torch.autograd.grad(plain_out, leaves,
                                      torch.from_numpy(cot))
    with torch.no_grad():
        out, dx, grads = _wide_kernel_model(x, wt, F, torch.from_numpy(cot),
                                            2)
    assert_close(out, plain_out.detach(), 1e-5, "out")
    assert_close(out, ref_out, 2e-2, "out vs JAX")
    jax_grads = [np.asarray(r) for r in [jdx, *jdw]]
    for i, (got, ref, jref) in enumerate(zip([dx] + grads, plain_grads,
                                             jax_grads)):
        got, ref = got.numpy(), ref.numpy()
        assert got.shape == ref.shape == jref.shape, i
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), i
        assert (np.linalg.norm(got - jref)
                <= 5e-2 * np.linalg.norm(jref)), i
    rows = np.abs(dx.numpy() - jax_grads[0]).max(1)
    assert (rows <= 2e-2 * np.abs(jax_grads[0]).max()).mean() >= 0.98


# cropnerf-mxu-q's step moves further from JAX's than cropnerf-mxu's:
# tools/torch_train_parity_draws.py --preset cropnerf-mxu-q measures, over
# ten draws of 32 pixels in float32, the rays' directions up to 3.40e-2 in
# relative L2 (3.00e-2 on the tests' draw; cropnerf-mxu: up to 1.04e-2)
# and a proposal net's hidden layer up to 1.46e-2 of its largest value
# (draw 6; the trunk's leaves up to 1.91e-2).  Its 128-wide proposal nets
# sharpen the samples' weights, so a relu unit that takes the other side
# moves a leaf further.  So every leaf behind a relu unit (the trunk's,
# and the hidden layers of the heads and of the proposal nets) and the
# rays are held in relative L2 to Q_KINK_TOL.  The step runs in the
# float32 arm alone: in bf16 JAX's own step moves camera_opt by 0.75 of
# its rays' gradient magnitudes from its float32 step (cropnerf-mxu:
# 0.28), and the wide nets' bf16 arithmetic is held by
# test_fused_pe_mlp_matches_jax's q cases, the render and the depth batch.
Q_KINK_TOL = {"f32": 5e-2}


def _q_kinked(leaf: str) -> bool:
    """The trunk's leaves and those of every layer but the last of the
    heads (2 layers) and the proposal nets (3)."""
    from test_torch_train import _kinked
    parts = leaf.split(".")
    n_layers = {"mlp_semantic": 2, "mlp_color": 2, "mlp": 3}.get(
        parts[-3] if len(parts) >= 3 else "")
    return _kinked(leaf) or (n_layers is not None
                             and int(parts[-1]) < n_layers - 1)


@pytest.mark.parametrize("arm", ["f32"], indirect=True)
def test_q_train_step_matches_jax(arm, monkeypatch):
    """The same step of cropnerf-mxu-q: its proposal nets 128 wide (the
    wide route's backward on the card), carried across by params_from_jax;
    the float32 arm (Q_KINK_TOL)."""
    _check_train_step("cropnerf-mxu-q", arm, monkeypatch, _q_kinked,
                      Q_KINK_TOL)


# cropnerf-mxu-q's render of the float32 arm: the port's semantic logits
# differ from JAX's by up to 3.0e-4 (2 of 64 pixels over 1e-4), with its
# proposal nets on the fused kernel or on plain matmuls alike (2.9e-4), so
# the fused nets add nothing; JAX's own fused and plain proposal nets give
# renders 7.2e-5 apart (cropnerf-mxu: 1.5e-5, the port 3.0e-5).
# tools/q_render_stages.py finds every stage within float32 rounding of
# JAX's on the same inputs: the PE field magnifies the resampled
# positions' last bits, and -q's sharper weights carry them into the
# semantics (ROADMAP.md Queue 3).
Q_SEMANTICS_TOL = {"f32": 5e-4, "bf16": 2e-2}


def test_q_render_matches_jax(arm):
    """The same render of cropnerf-mxu-q with fused proposals, the
    semantic logits to Q_SEMANTICS_TOL."""
    _check_render("cropnerf-mxu-q", arm, Q_SEMANTICS_TOL[arm.name])


def test_q_forward_and_depth_batch_match_jax(arm, monkeypatch):
    """The same depth batch of cropnerf-mxu-q with fused proposals."""
    _check_forward_and_depth_batch("cropnerf-mxu-q", arm, monkeypatch)
