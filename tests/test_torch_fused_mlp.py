"""The fused relu MLP (K3, ``fused_mlp``: the vanilla field's heads) of the
PyTorch port: its route by shape, the wgmma kernels' weight images (64,
128 and 256 hidden columns; K5's, which share the gather, byte for byte
as before), a CPU model of their arithmetic on those images, the plain
version against the JAX kernel at ``cropnerf-mxu-big``'s head shapes, and
the weight images' lifetime under a checkpoint.

The kernels themselves run only on the card (tests/test_torch_gpu.py).
The JAX kernel runs as its own tests run it on the CPU (interpret mode on
128-row tiles, or its jnp path for a ragged N).  Tolerances: the float32
arm 1e-4 and the bf16 arm 2e-2 of ``torch_parity``; the kernel model
against the JAX VJP as the card's tests hold the kernels (dx row by row,
the rest in relative L2: bf16 operands, f32 sums in another order).
"""
from __future__ import annotations

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cropnerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from cropnerf_tpu_torch.models.config import PRESETS
from cropnerf_tpu_torch.ops.cuda import fused_mlp as tmlp
from cropnerf_tpu_torch.ops.cuda.common import pad16
from torch_parity import (arm, assert_close, np_wbs, to_jax,  # noqa: F401
                          to_torch)

OW = 16                   # csrc/wgmma_mlp.cuh: output padding


# the heads of every preset whose field runs them through fused_mlp
# (mlp_impl "pallas-fused"): (semantic head, colour head) and their routes
HEAD_ROUTES = {
    "cropnerf-mxu": (([15, 64, 1], "wgmma"), ([74, 64, 3], "wgmma")),
    "cropnerf-mxu-q": (([15, 64, 1], "wgmma"), ([74, 64, 3], "wgmma")),
    "cropnerf-mxu-big": (([30, 128, 128, 1], "wgmma"),
                         ([185, 128, 3], "wgmma")),
    "cropnerf-mxu-huge": (([30, 128, 128, 1], "wgmma"),
                          ([89, 256, 3], "wgmma")),
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fused_mlp_route_by_preset(preset):
    """Every preset's heads: the cropnerf-mxu family runs them through
    fused_mlp, all on the wgmma kernels (-mxu and -q 64 wide, -big and
    -huge 128 and 256 wide); every other preset computes its heads on
    plain matmuls (mlp_impl "xla"), never reaching the kernel.  The widths
    are the ones the field's own init builds."""
    from cropnerf_tpu_torch.models.vanilla import vanilla_field_init
    f = PRESETS[preset].model.field
    if preset not in HEAD_ROUTES:
        assert f.mlp_impl == "xla"
        return
    field = vanilla_field_init(f, 2, torch.Generator().manual_seed(0))
    built = [[m.w[0].shape[0]] + [w.shape[1] for w in m.w]
             for m in (field.mlp_semantic, field.mlp_color)]
    assert built == [dims for dims, _ in HEAD_ROUTES[preset]]
    for dims, route in HEAD_ROUTES[preset]:
        assert tmlp.fused_mlp_route(dims[0], dims[1:]) == route


# (din, output widths, route): the wgmma kernels' edges.  A net takes them
# where its weight images and one warpgroup's tiles fit shared memory
# (the backward with weight gradients needs most); the stream route takes
# the rest up to 512 wide and 32 layers; None: no kernel.
ROUTE_EDGES = [(128, [64, 16], "wgmma"),      # the widest input at 64
               (129, [64, 1], "wgmma"),       # one more: padded to 128
               (1, [8, 1], "wgmma"),          # one input, a narrow layer
               (39, [64, 48, 16], "wgmma"),   # three layers
               (15, [64, 64, 64, 1], "stream"),  # four layers
               (15, [1], "stream"),           # one layer
               (15, [65, 1], "wgmma"),        # a hidden layer of 65: 128
               (15, [64, 17], "stream"),      # 17 outputs
               (89, [256, 3], "wgmma"),       # 256 hidden (-huge's colour)
               (15, [513, 1], None),          # 513 hidden: no kernel
               (15, [257, 1], "stream"),      # 257 hidden: stream, wide
               (15, [512, 1], "stream"),      # [w512]'s semantic head
               (96, [256, 3], "wgmma"),       # the widest input at 256
               (97, [256, 3], "stream"),      # one more: shared memory
               (205, [128, 3], "wgmma"),      # the widest input at 128
               (206, [128, 3], "stream"),     # one more: shared memory
               (93, [128, 128, 1], "wgmma"),  # the widest 3-layer input
               (94, [128, 128, 1], "stream"),  # one more: shared memory
               (30, [256, 256, 1], "stream"),  # 3 layers 256 wide
               (256, [8, 1], "stream"),       # din 256: shared memory
               (513, [8, 1], None),           # din over 512
               (257, [8, 1], "stream"),       # din over 256: wide
               (512, [512] * 32, "stream"),   # 32 layers 512 wide, din 512
               (40, [128] * 5 + [7], "stream"),  # 6 layers 128 wide
               (256, [256] * 32, "stream"),   # 32 layers 256 wide
               (15, [64] * 33, None)]         # 33 layers


@pytest.mark.parametrize("case", range(len(ROUTE_EDGES)))
def test_fused_mlp_route_edges(case):
    din, widths, route = ROUTE_EDGES[case]
    if route is None:
        with pytest.raises(ValueError, match="no kernel"):
            tmlp.fused_mlp_route(din, widths)
        return
    assert tmlp.fused_mlp_route(din, widths) == route


def _operands(wbs):
    """The weight images of ``mlp_images`` read back as the wgmma kernels
    index them: per layer the forward B operand [K, width] (element (k, n)
    at (k/8)·width·8 + n·8 + k%8 of its image) and the input-gradient B
    operand of Wᵀ (element (n, k) at (n/8)·K·8 + k·8 + n%8), both returned
    as [K, width] with K = din padded to 16 for layer 0 and the net's
    padded hidden width H after, and the padded biases; the layers'
    offsets in the forward half, the padded widths and H."""
    n_layers = len(wbs) // 2
    img, bias = tmlp.mlp_images(wbs)
    hw = tmlp._hidden(wbs)
    ks = [pad16(wbs[0].shape[0])] + [hw] * (n_layers - 1)
    widths = [hw] * (n_layers - 1) + [OW]
    half = sum(k * w for k, w in zip(ks, widths))
    assert img.numel() == 2 * half
    fw, bw, offs, off = [], [], [], 0
    for K, N in zip(ks, widths):
        k, n = torch.arange(K)[:, None], torch.arange(N)[None]
        fw.append(img[off + (k // 8) * N * 8 + n * 8 + k % 8].float())
        bw.append(img[half + off + (n // 8) * K * 8 + k * 8 + n % 8].float())
        offs.append(off)
        off += K * N
    return fw, bw, bias, offs, widths, hw


@pytest.mark.parametrize("dims", [[15, 64, 1], [74, 64, 3], [39, 64, 48, 16],
                                  [128, 32, 16], [1, 8, 1],
                                  [30, 128, 128, 1], [185, 128, 3],
                                  [89, 256, 3]])
def test_mlp_images_ungather_to_the_padded_weights(dims):
    """Both halves of the wgmma kernels' images, read back as the kernels
    index them, are the weights rounded to bf16 and zero-padded to [din
    rounded to 16, H], [H, H] and [H, 16], H 64, 128 (-big's heads, -huge's
    semantic head) or 256 (-huge's colour head); the biases padded alike;
    the forward half alone is the image's first half, bit for bit."""
    wt = to_torch(np_wbs(np.random.default_rng(7), dims))
    fw, bw, bias, _, widths, hw = _operands(wt)
    assert hw == (64 if dims[1] <= 64 else dims[1])
    b_off = 0
    for l, width in enumerate(widths):
        w, b = wt[2 * l], wt[2 * l + 1].reshape(-1)
        padded = torch.zeros(fw[l].shape)
        padded[:w.shape[0], :w.shape[1]] = w.bfloat16().float()
        assert torch.equal(fw[l], padded) and torch.equal(bw[l], padded), l
        assert torch.equal(bias[b_off:b_off + width],
                           torch.nn.functional.pad(b, (0, width - b.numel())))
        b_off += width
    img, got_bias = tmlp.mlp_images(wt)
    fwd_img, fwd_bias = tmlp.mlp_images(wt, backward=False)
    assert torch.equal(fwd_img, img[:img.numel() // 2])
    assert torch.equal(fwd_bias, got_bias)


def _kernel_model(x, wbs, g):
    """The wgmma kernels' arithmetic in torch on the operands read back from
    ``mlp_images`` (``_operands``): the forward (x rounded to bf16 and
    zero-padded, each product with f32 sums plus the f32 bias, relu and
    bf16 for the hidden layers) and the backward (the last layer's
    cotangent rounded as the product operand, its f32 column sums the bias
    gradient; G·Wᵀ on the input-gradient operands, the relu mask of the
    bf16 activation in f32; dW_l = A_lᵀ·G_l of bf16 operands, layer 0's as
    (G_0ᵀ·A_0)ᵀ), the weight gradients packed into the partial row's layout
    and unpacked by ``unpack_images_grads``.  Returns (out, dx, grads)."""
    N, din = x.shape
    dout, n_layers = wbs[-2].shape[1], len(wbs) // 2
    fw, bw, bias, offs, widths, hw = _operands(wbs)
    b_at = [l * hw for l in range(n_layers)]
    a = torch.zeros((N, fw[0].shape[0]))
    a[:, :din] = x
    acts = [a.bfloat16().float()]
    for l in range(n_layers - 1):
        acts.append(torch.relu(acts[l] @ fw[l] + bias[b_at[l]:b_at[l] + hw])
                    .bfloat16().float())
    out = (acts[-1] @ fw[-1] + bias[b_at[-1]:b_at[-1] + OW])[:, :dout]
    gcur = torch.zeros((N, OW))
    gcur[:, :dout] = g
    dw = torch.zeros(sum(f.numel() for f in fw))
    db = torch.zeros(bias.numel())
    for l in range(n_layers - 1, -1, -1):
        width = widths[l]
        db[b_at[l]:b_at[l] + width] = gcur.sum(0)
        gb = gcur.bfloat16().float()
        grad_w = (acts[l].T @ gb if l else (gb.T @ acts[0]).T)
        dw[offs[l]:offs[l] + grad_w.numel()] = grad_w.reshape(-1)
        v = gb @ bw[l].T
        if l:
            gcur = torch.where(acts[l] > 0, v, 0.0)
    dx = v[:, :din]
    return out, dx, tmlp.unpack_images_grads(wbs, dw, db)


@pytest.mark.parametrize("dims,n", [([74, 64, 3], 384), ([15, 64, 1], 300),
                                    ([39, 64, 48, 16], 256),
                                    ([89, 256, 3], 256)],
                         ids=["colour-head", "semantic-head-ragged",
                              "three-layers", "huge-colour-head"])
def test_kernel_model_reproduces_jax(dims, n):
    """The kernels' model against autograd through the plain version (the
    same roundings: 1e-2 of max), and against the JAX VJP of fused_mlp
    (its kernel in interpret mode at 384 and 256 rows; at 300 rows, no tile
    divisor, its jnp path): the output to 2e-2 of max, dx row by row (2e-2
    of max on 98 % of rows) and every gradient to 5e-2 in relative L2, the
    card's gradient tolerance.  In the three-layer net XLA sums layer 1 in
    another order, so a few of its bf16 activations round to the other
    neighbour and their rows' relu masks differ (3 of 256 rows here, 16 %
    of max dx each); torch and the model agree there.  -huge's colour head
    runs on images 256 wide."""
    rng = np.random.default_rng(60 + n)
    xn = rng.standard_normal((n, dims[0])).astype(np.float32)
    wn = np_wbs(rng, dims)
    cot = rng.standard_normal((n, dims[-1])).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda x, w: jax_fused_mlp(x, w, 128, True),
                           jnp.asarray(xn), to_jax(wn))
    jax_grads = [np.asarray(r) for r in (lambda d, w: [d, *w])(
        *vjp(jnp.asarray(cot)))]
    x, wt = torch.from_numpy(xn), to_torch(wn)
    leaves = [t.clone().requires_grad_(True) for t in (x, *wt)]
    plain_out = tmlp.fused_mlp_plain(leaves[0], leaves[1:])
    plain_grads = torch.autograd.grad(plain_out, leaves,
                                      torch.from_numpy(cot))
    with torch.no_grad():
        out, dx, grads = _kernel_model(x, wt, torch.from_numpy(cot))
    assert_close(out, plain_out.detach(), 1e-5, "out")
    assert_close(out, ref_out, 2e-2, "out vs JAX")
    for i, (got, ref, jref) in enumerate(zip([dx] + grads, plain_grads,
                                             jax_grads)):
        got, ref = got.numpy(), ref.numpy()
        assert got.shape == ref.shape == jref.shape, i
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), i
        assert (np.linalg.norm(got - jref)
                <= 5e-2 * np.linalg.norm(jref)), i
    rows = np.abs(dx.numpy() - jax_grads[0]).max(1)
    assert (rows <= 2e-2 * np.abs(jax_grads[0]).max()).mean() >= 0.98


@pytest.mark.parametrize("dims", [[30, 128, 128, 1], [185, 128, 3]],
                         ids=["semantic-head", "colour-head"])
def test_fused_mlp_plain_matches_jax_at_big_heads(dims, arm):
    """fused_mlp_plain (the CPU path of fused_mlp) against the JAX kernel
    in interpret mode at cropnerf-mxu-big's two head shapes, 256 rows."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, dims[0])).astype(np.float32)
    wbs = np_wbs(rng, dims)
    ref = jax_fused_mlp(jnp.asarray(x), to_jax(wbs), 128, True)
    got = tmlp.fused_mlp(torch.from_numpy(x), to_torch(wbs), arm.dtype)
    assert_close(got, ref, arm.tol, "y")


def _stand_in_kernels(monkeypatch):
    """The K3 kernels' entry points stood in for by the plain version,
    recording what each was handed."""
    seen = {}

    def launch(x, wbs, img, bias):
        seen["fwd"] = (img, bias)
        return tmlp.fused_mlp_plain(x, wbs)

    def stream(x, wbs):
        seen["stream"] = True
        return tmlp.fused_mlp_plain(x, wbs)

    def bwd(x, wbs, g, need_dx, need_dw, images):
        seen["bwd"] = images
        return None, [torch.zeros_like(w) for w in wbs]

    monkeypatch.setattr(tmlp, "_wgmma_forward", launch)
    monkeypatch.setattr(tmlp, "fused_mlp_stream", stream)
    monkeypatch.setattr(tmlp, "fused_mlp_bwd", bwd)
    return seen


def _net(dims, seed=40):
    rng = np.random.default_rng(seed)
    wt = to_torch(np_wbs(rng, dims))
    x = torch.from_numpy(rng.standard_normal((100, dims[0]))
                         .astype(np.float32))
    return x, wt


# a net on each route: cropnerf-mxu's colour head, and a 3-layer net 256
# wide, too large for the wgmma kernels' shared memory
ROUTE_NETS = [[74, 64, 3], [30, 256, 256, 1]]


@pytest.mark.parametrize("dims", ROUTE_NETS, ids=["wgmma", "stream"])
def test_forward_saves_its_images_for_the_backward(dims, monkeypatch):
    """Where a graph is recorded, the card path of the wgmma route builds
    the weight images once, in the forward, and hands those very tensors
    to the backward; the stream route builds none (its kernels gather
    their own).  The kernels are stood in for by the plain version."""
    x, wt = _net(dims)
    wt = [w.requires_grad_(True) for w in wt]
    seen = _stand_in_kernels(monkeypatch)
    out = tmlp._fused_mlp_card(x, wt)
    out.sum().backward()
    if tmlp.fused_mlp_route(dims[0], dims[1:]) == "stream":
        assert seen == {"stream": True, "bwd": None}
        return
    img, bias = tmlp.mlp_images([w.detach() for w in wt])
    assert all(a is b for a, b in zip(seen["bwd"], seen["fwd"]))
    assert torch.equal(seen["fwd"][0], img)
    assert torch.equal(seen["fwd"][1], bias)


@pytest.mark.parametrize("dims", ROUTE_NETS, ids=["wgmma", "stream"])
def test_forward_without_a_graph_builds_only_forward_images(dims,
                                                            monkeypatch):
    """Where no graph is recorded (the export, the render), the card path
    launches the forward kernel its route picks and builds no backward
    half: the wgmma kernel gets the forward images alone, the stream route
    none."""
    x, wt = _net(dims)
    seen = _stand_in_kernels(monkeypatch)
    with torch.no_grad():
        out = tmlp._fused_mlp_card(x, [w.requires_grad_(True) for w in wt])
    assert not out.requires_grad
    if tmlp.fused_mlp_route(dims[0], dims[1:]) == "stream":
        assert seen == {"stream": True}
        return
    img, bias = tmlp.mlp_images(wt)
    assert set(seen) == {"fwd"}
    assert torch.equal(seen["fwd"][0], img[:img.numel() // 2])
    assert torch.equal(seen["fwd"][1], bias)


@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_pe_mlp"])
def test_checkpoint_frees_the_weight_images(kernel, monkeypatch):
    """Under torch.utils.checkpoint (non-reentrant, as models/model.py's
    remat runs it) the weight images K3's and K5's forwards build are saved
    through save_for_backward, so the checkpoint's hooks drop them: no
    image tensor stays referenced after the forward.  The backward's
    replay builds them again, and the backward kernel gets those.  The
    kernels are stood in for by the plain version."""
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
    refs, got = [], []

    def keep(img, bias):
        refs.extend(weakref.ref(t) for t in (img, bias))

    def bwd(*args):
        wbs, images = args[1], args[-1]
        got.append([t.clone() for t in images])
        return None, [torch.zeros_like(w) for w in wbs]

    rng = np.random.default_rng(41)
    if kernel == "fused_mlp":
        x, wt = _net([74, 64, 3])
        monkeypatch.setattr(tmlp, "_wgmma_forward", lambda x, wbs, img, bias: (
            keep(img, bias), tmlp.fused_mlp_plain(x, wbs))[1])
        monkeypatch.setattr(tmlp, "fused_mlp_bwd", bwd)
        images = tmlp.mlp_images
        fn = lambda x, *wbs: tmlp._fused_mlp_card(x, list(wbs))  # noqa: E731
    else:
        wt = to_torch(np_wbs(rng, [33, 64, 64, 1]))
        x = torch.from_numpy(rng.uniform(-1, 1, (100, 3)).astype(np.float32))
        monkeypatch.setattr(tfield, "_pe_mlp_fwd_launch",
                            lambda x, wbs, f, img, bias: (
                                keep(img, bias),
                                tfield.fused_pe_mlp_plain(x, wbs, f))[1])
        monkeypatch.setattr(tfield, "fused_pe_mlp_bwd", bwd)
        images = tfield.pe_mlp_images
        fn = lambda x, *wbs: tfield._fused_pe_mlp_card(  # noqa: E731
            x, list(wbs), 5)
    wt = [w.requires_grad_(True) for w in wt]
    out = torch.utils.checkpoint.checkpoint(fn, x, *wt, use_reentrant=False)
    gc.collect()
    assert len(refs) == 2 and all(r() is None for r in refs)
    out.sum().backward()
    assert len(refs) == 4 and len(got) == 1
    want = images([w.detach() for w in wt])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 → bf16 bit patterns, round to nearest even."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _images_64_model(wbs: list, k0: int) -> tuple:
    """The 64-wide weight images in numpy, element by element as the
    kernels index them: every layer's weight zero-padded to [k0, 64]
    (layer 0), [64, 64] or [64, 16] (the last); the forward images
    (element (k, n) of a [K, width] weight at (k/8)·width·8 + n·8 + k%8),
    then the input-gradient images of Wᵀ ((n, k) at (n/8)·K·8 + k·8 +
    n%8), as bf16 bits; the biases padded alike, float32."""
    n_layers = len(wbs) // 2
    fwd, bwd, bias = [], [], []
    for l in range(n_layers):
        w, b = wbs[2 * l], wbs[2 * l + 1].reshape(-1)
        K = k0 if l == 0 else 64
        width = OW if l == n_layers - 1 else 64
        wp = np.zeros((K, width), np.float32)
        wp[:w.shape[0], :w.shape[1]] = w
        f = np.zeros(K * width, np.uint16)
        g = np.zeros(K * width, np.uint16)
        bits = _bf16_bits(wp)
        for k in range(K):
            for n in range(width):
                f[(k // 8) * width * 8 + n * 8 + k % 8] = bits[k, n]
                g[(n // 8) * K * 8 + k * 8 + n % 8] = bits[k, n]
        fwd.append(f)
        bwd.append(g)
        bias.append(np.pad(b, (0, width - b.size)).astype(np.float32))
    return (np.concatenate(fwd), np.concatenate(fwd + bwd),
            np.concatenate(bias))


@pytest.mark.parametrize("dims", [[33, 64, 64, 1], [63, 64, 1],
                                  [39, 64, 48, 16]])
def test_pe_mlp_images_keep_the_64_wide_layout(dims):
    """K5's weight images (pe_mlp_images: every layer's rows padded to 64)
    share the gather the wider K3 images use; they stay byte for byte the
    64-wide layout, written out element by element in numpy, both halves
    and the forward half alone; so do K3's images of a 64-wide net."""
    from cropnerf_tpu_torch.ops.cuda import fused_pe_field as tfield
    wn = np_wbs(np.random.default_rng(43), dims)
    fwd, both, bias = _images_64_model(wn, 64)
    for backward, want in ((True, both), (False, fwd)):
        img, got_bias = tfield.pe_mlp_images(to_torch(wn), backward)
        assert np.array_equal(img.view(torch.int16).numpy().view(np.uint16),
                              want)
        assert got_bias.numpy().tobytes() == bias.tobytes()
    fwd, both, bias = _images_64_model(wn, pad16(dims[0]))
    img, got_bias = tmlp.mlp_images(to_torch(wn))
    assert np.array_equal(img.view(torch.int16).numpy().view(np.uint16), both)
    assert got_bias.numpy().tobytes() == bias.tobytes()
