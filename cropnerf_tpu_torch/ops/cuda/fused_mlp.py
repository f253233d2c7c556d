"""Fused relu MLP, forward and backward (counterpart of
``cropnerf_tpu/ops/pallas/fused_mlp.py``).

``fused_mlp`` launches CUDA kernels for a tensor on the card and computes
``fused_mlp_plain``, the same arithmetic in plain PyTorch, for a tensor on
the CPU (autograd through it is the CPU backward).  The kernels replace
the Pallas ``_fwd_kernel`` and ``_bwd_kernel``; they run the vanilla
field's semantic and colour heads on the export path and in the BayesRays
pass, and are mostly memory-bound on an H100 (see the sources' notes).  A net's
shape alone picks its kernels (``fused_mlp_route``):

- "wgmma", every head of the ``cropnerf-mxu`` family (2 or 3 layers,
  hidden widths up to 256, up to 256 inputs and 16 outputs, and a net
  whose weight images and one warpgroup's tiles fit a block's shared
  memory): ``csrc/fused_mlp_fwd.cu`` and ``csrc/fused_mlp_bwd.cu``,
  persistent warpgroups on ``wgmma`` with the net resident in shared
  memory as the weight images ``mlp_images`` builds once per call (the
  forward half alone where no graph is recorded) and the backward reuses,
  hidden layers padded to 64 (``-mxu``, ``-q``), 128 (``-big``; the
  semantic head of ``-huge``) or 256 (``-huge``'s colour head,
  ``mlp_hidden_pad``); launches counted on ``fused_mlp`` and
  ``fused_mlp_bwd``;
- "stream", every other net of 1 to 32 layers whose input and layers are
  at most 512 wide (more layers, more outputs, a net too large for shared
  memory, such as ``-huge`` with a 256-wide semantic head, or one wider
  than 256, such as a 512-wide semantic head, which runs with both
  warpgroups on one tile, each half of every product):
  ``csrc/fused_mlp_stream.cu``, ``wgmma`` with the weights streamed
  through shared memory, on the programs ``mlp_plan.py`` builds; launches
  counted on ``fused_mlp_stream`` and ``fused_mlp_stream_bwd``.

A wider net has no kernel: on the card ``fused_mlp`` raises for it.  On
the card the backward (``fused_mlp_bwd``) recomputes the forward from x
and the weights, as the JAX custom VJP saves only ``(x, wbs)``, and
computes only the gradients autograd asks for: dx alone when no weight
needs one.  The ragged tail of N is masked in the kernels; there is no
fallback.  ``fused_pe_field.fused_pe_mlp`` (the PE proposal nets) takes
the PE variants of both routes for nets wider than its own kernels:
``wgmma_forward`` and ``wgmma_backward``, ``stream_forward`` and
``stream_backward`` with ``num_freqs``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ..mlp import mm_f32acc
from . import build
from .common import (MAX_SMEM_BYTES, PE_ENC, STREAM_MAX_WIDTH,
                     WGMMA_HIDDEN, WGMMA_OUT, c_ints, check_images,
                     check_kernel_call, check_rows, pad16, persistent_blocks,
                     sm_count, stream_ptr, unpack_layers, weight_images)
from .mlp_plan import (MAX_LAYERS, program_key, stream_images,
                       stream_layers, stream_plan, stream_takes)


def fused_mlp_plain(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                    compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, Din] → [N, Dout] f32 through wbs = [W0, b0, W1, b1, ...]:
    operands rounded to ``compute_dtype``, f32 accumulation, relu and a
    rounding after every hidden layer."""
    n_layers = len(wbs) // 2
    h = x
    for i in range(n_layers):
        h = mm_f32acc(h, wbs[2 * i], compute_dtype) + wbs[2 * i + 1]
        if i < n_layers - 1:
            h = torch.relu(h).to(compute_dtype)
    return h.float()


def _layers(wbs: Sequence[torch.Tensor]):
    """``common.pack_layers``' layers of the net ``wbs``."""
    return [([(wbs[2 * i], pad16(wbs[2 * i].shape[0]))], wbs[2 * i + 1])
            for i in range(len(wbs) // 2)]


# csrc/wgmma_mlp.cuh max_kb: the widest input the wgmma kernels take, and
# the widest where layer 0's A operand holds 8 k-steps in registers (the
# nets padded to 64 hidden columns and every 3-layer net)
MLP_MAX_DIN, MLP_MAX_DIN_8 = 256, 128


def mlp_hidden_pad(din: int, widths: Sequence[int]) -> int:
    """The hidden width the wgmma kernels pad a net x [N, din] →
    ``widths`` to: 64, 128 or 256, the first at or above every hidden
    layer (128 at least for din over 128); 0 for a layer over 256."""
    need = max(widths[:-1])
    if din > MLP_MAX_DIN_8:
        need = max(need, WGMMA_HIDDEN + 1)
    return next((hw for hw in (64, 128, 256) if need <= hw), 0)


def _al128(n: int) -> int:
    return (n + 127) // 128 * 128


def _least_bwd_smem(din: int, dout: int, n_layers: int, hw: int,
                    pe: bool = False) -> int:
    """Shared memory a block of the wgmma backward with weight gradients
    takes at one warpgroup, one stage and one set of operand tiles: the
    least that the largest of the net's kernels needs.  K3's
    (``csrc/wgmma_mlp.cuh`` ``BwdSmem``): both image halves and the
    biases, an x and g tile, the operand tiles, the stage's barrier, the
    warps' bias rows.  With ``pe`` K5's wide backward's
    (``csrc/fused_pe_mlp_wide_bwd.cu`` ``WideSmem``, a PE net whose layer
    0 takes the din-column encoding of x [N, 3]): the forward images alone
    and the biases, a g tile, the derivative tile, the operand tiles, the
    barriers of the stage and of the sets, the warps' bias rows."""
    kp, n_bias = pad16(din), (n_layers - 1) * hw + WGMMA_OUT
    fwd_elems = kp * hw + (n_layers - 2) * hw * hw + hw * WGMMA_OUT
    tiles = 64 * 2 * (kp + 2 * (n_layers - 1) * hw + WGMMA_OUT)
    if pe:
        derivs = 64 * 4 * (PE_ENC + 4)
        block = _al128(64 * 4 * dout + derivs + _al128(tiles) + 8 * 5)
        return _al128(2 * fwd_elems + 4 * n_bias) + block + 16 * n_bias
    warpgroup = _al128(64 * 4 * (din + dout) + tiles + 8)
    return _al128(4 * fwd_elems + 4 * n_bias) + warpgroup + 16 * n_bias


def fused_mlp_route(din: int, widths: Sequence[int]) -> str:
    """The kernels a net x [N, din] → ``widths`` (each layer's output
    width) takes on the card, by its shape alone: "wgmma"
    (``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_bwd.cu``) for 2 or 3
    layers with hidden widths up to 256, din up to 256 (128 for 3 layers)
    and up to 16 outputs whose weight images and one warpgroup's tiles fit
    a block's shared memory (every head of the ``cropnerf-mxu`` family),
    else "stream" (``csrc/fused_mlp_stream.cu``) for 1 to 32 layers with
    din and every width up to 512 (every layout of which fits a block's
    shared memory).  Raises ValueError for a wider or deeper net, which no
    kernel takes."""
    max_din = MLP_MAX_DIN_8 if len(widths) == 3 else MLP_MAX_DIN
    if (len(widths) in (2, 3) and 1 <= din <= max_din
            and 1 <= widths[-1] <= WGMMA_OUT):
        hw = mlp_hidden_pad(din, widths)
        if hw and _least_bwd_smem(din, widths[-1], len(widths),
                                  hw) <= MAX_SMEM_BYTES:
            return "wgmma"
    if stream_takes(din, widths):
        return "stream"
    raise ValueError(f"fused_mlp: no kernel takes x [N, {din}] -> "
                     f"{list(widths)} (at most {MAX_LAYERS} layers, each "
                     f"and the input at most {STREAM_MAX_WIDTH} wide)")


def _widths(wbs) -> list:
    return [w.shape[1] for w in wbs[0::2]]


def _route(x, wbs) -> str:
    return fused_mlp_route(x.shape[1], _widths(wbs))


def _hidden(wbs) -> int:
    return mlp_hidden_pad(wbs[0].shape[0], _widths(wbs))


def mlp_images(wbs: Sequence[torch.Tensor], backward: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgmma kernels' weights (``common.weight_images``): layer 0's
    rows padded to din rounded up to 16, every other layer's to the net's
    padded hidden width (``mlp_hidden_pad``)."""
    return weight_images(wbs, pad16(wbs[0].shape[0]), backward, _hidden(wbs))


def _wgmma_lib(name: str, entry: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    getattr(lib, f"{entry}_layout").restype = ctypes.c_int
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_lib():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _wgmma_lib("fused_mlp_fwd", "cropnerf_mlp_fwd",
                     [vp] * 4 + [i32] * 5 + [ctypes.c_longlong, i32, vp])
    lib.cropnerf_mlp_fwd_layout.argtypes = [i32] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _wgmma_lib("fused_mlp_bwd", "cropnerf_mlp_bwd",
                     [vp] * 5 + [i32] * 5 + [ctypes.c_longlong, i32]
                     + [vp] * 5)
    lib.cropnerf_mlp_bwd_layout.argtypes = [i32] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


@functools.lru_cache(maxsize=None)
def _pe_wide_bwd_lib():
    """``csrc/fused_pe_mlp_wide_bwd.cu``: K5's wide backward with weight
    gradients, with ``fused_mlp_bwd.cu``'s C signatures."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _wgmma_lib("fused_pe_mlp_wide_bwd", "cropnerf_pe_wide_bwd",
                     [vp] * 5 + [i32] * 5 + [ctypes.c_longlong, i32]
                     + [vp] * 5)
    lib.cropnerf_pe_wide_bwd_layout.argtypes = [i32] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


def _bwd_entry(need_dw, pe: bool):
    """(library, entry name) of the wgmma backward: K5's wide backward
    for a PE net with weight gradients, else ``fused_mlp_bwd.cu``'s."""
    if pe and need_dw:
        return _pe_wide_bwd_lib(), "cropnerf_pe_wide_bwd"
    return _bwd_lib(), "cropnerf_mlp_bwd"


@functools.lru_cache(maxsize=None)
def mlp_layout(din: int, dout: int, n_layers: int, hw: int,
               need_dw=None, pe: bool = False) -> list:
    """The sizes the wgmma forward (``need_dw`` None: image and bias
    elements, shared memory, warpgroups a block, x stages a warpgroup) or
    backward kernel's C layout function (image and bias elements,
    partial-row sizes, shared memory, warpgroups a block that take tiles,
    weight partial rows a block, stages; K5's wide backward also its
    operand-tile sets) reports for a net with hidden layers padded to
    ``hw`` (with ``pe``, the PE variant's, layer 0 taking the din-column
    encoding of x [N, 3])."""
    sizes = (ctypes.c_longlong * 9)()
    if need_dw is None:
        err = _fwd_lib().cropnerf_mlp_fwd_layout(din, dout, n_layers, hw,
                                                 int(pe), sizes)
    else:
        lib, entry = _bwd_entry(need_dw, pe)
        err = getattr(lib, f"{entry}_layout")(din, dout, n_layers, hw,
                                              int(need_dw), int(pe), sizes)
    if err:
        raise ValueError(f"fused_mlp: the wgmma kernels do not take x [N, "
                         f"{din}] -> {n_layers} layers ({hw} wide) -> {dout}"
                         + (" (PE)" if pe else ""))
    n = 5 if need_dw is None else 9 if pe and need_dw else 8
    return list(sizes[:n])


def net_layout(wbs: Sequence[torch.Tensor], need_dw=None,
               pe: bool = False) -> list:
    """``mlp_layout`` of the net ``wbs``."""
    return mlp_layout(wbs[0].shape[0], wbs[-2].shape[1], len(wbs) // 2,
                      _hidden(wbs), need_dw, pe)


def wgmma_forward(name, x, wbs, img, bias, num_freqs: int = -1
                  ) -> torch.Tensor:
    """One launch of ``csrc/fused_mlp_fwd.cu`` on CUDA tensors (none for
    N = 0) on ``mlp_images``, with or without the backward's half: the
    [N, Dout] float32 output.  ``num_freqs`` >= 0: the PE variant, x
    [N, 3] encoded with that many frequencies into layer 0's input."""
    device, n, din = x.device, x.shape[0], wbs[0].shape[0]
    dout, n_layers, hw = wbs[-2].shape[1], len(wbs) // 2, _hidden(wbs)
    fwd_elems, n_bias, _, wgs = mlp_layout(din, dout, n_layers, hw,
                                           pe=num_freqs >= 0)[:4]
    check_images(name, img, bias, (fwd_elems, 2 * fwd_elems), n_bias)
    out = torch.empty((n, dout), dtype=torch.float32, device=device)
    if n == 0:
        return out
    blocks = persistent_blocks(n, sm_count(device), wgs)
    with torch.cuda.device(device):
        err = _fwd_lib().cropnerf_mlp_fwd(
            x.data_ptr(), out.data_ptr(), img.data_ptr(), bias.data_ptr(),
            din, dout, n_layers, hw, num_freqs, n, blocks, stream_ptr(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def _wgmma_forward(x, wbs, img, bias) -> torch.Tensor:
    """``wgmma_forward`` of ``fused_mlp``, counted."""
    out = wgmma_forward("fused_mlp", x, wbs, img, bias)
    if x.shape[0]:
        fused_mlp.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _stream_lib():
    """``csrc/fused_mlp_stream.cu``: the stream route's forward and
    backward, K3's and K5's."""
    lib = build.load("fused_mlp_stream")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    prog = [ctypes.POINTER(ctypes.c_int), vp, i32, i64]
    lib.cropnerf_mlp_stream_fwd.argtypes = [vp] * 4 + prog + [vp]
    lib.cropnerf_mlp_stream_bwd.argtypes = [vp] * 5 + prog + [vp] * 7
    for f in ("bwd_sizes", "bwd_grid", "fwd_grid"):
        getattr(lib, f"cropnerf_mlp_stream_{f}").argtypes = prog[:1] + [
            i32, i64, ctypes.POINTER(ctypes.c_longlong)]
    for f in ("fwd", "bwd"):
        getattr(lib, f"cropnerf_mlp_stream_{f}_smem_bytes").argtypes = [
            ctypes.POINTER(ctypes.c_int), i32]
    for f in ("fwd", "bwd", "bwd_sizes", "bwd_grid", "fwd_grid",
              "fwd_smem_bytes", "bwd_smem_bytes"):
        getattr(lib, f"cropnerf_mlp_stream_{f}").restype = ctypes.c_int
    return lib


def stream_bwd_grid(key: tuple, n_rows: int) -> dict:
    """The persistent grid of the stream backward's tile kernel for the
    program ``key`` at ``n_rows`` rows on the current card: the cluster
    size, the clusters resident at once, the blocks launched, and the C
    function's return (0, or the cudaError that refuses the launch)."""
    return _stream_grid("bwd", key, n_rows)


def stream_fwd_grid(key: tuple, n_rows: int) -> dict:
    """The stream forward's grid for the program ``key`` at ``n_rows``
    rows on the current card, as ``stream_bwd_grid`` gives the backward's:
    clusters of two a wide program, else persistent blocks, one an SM up
    to the tiles (cluster 0, no clusters resident)."""
    return _stream_grid("fwd", key, n_rows)


def _stream_grid(kind: str, key: tuple, n_rows: int) -> dict:
    prog = stream_plan(key).ints()
    out = (ctypes.c_longlong * 3)()
    err = getattr(_stream_lib(), f"cropnerf_mlp_stream_{kind}_grid")(
        c_ints(prog), len(prog), n_rows, out)
    if err == -1:
        raise ValueError("the stream kernel rejects this net")
    return dict(cluster=out[0], active_clusters=out[1], blocks=out[2],
                error=err)


def cluster_refusal(name: str, err: int, grid: dict, smem: int) -> str:
    """The message of a refused cluster launch: the error, the cluster
    size, the clusters that fit and a block's shared memory."""
    return (f"{name}: the cluster launch was refused (cudaError {err}): "
            f"clusters of {grid['cluster']} blocks of {smem} B of shared "
            f"memory, {grid['active_clusters']} resident at once, "
            f"{grid['blocks']} blocks; the kernel has no other grid")


@functools.lru_cache(maxsize=64)
def _stream_program(key: tuple, device: torch.device):
    """(the program's ints on the host, the same on the device) of
    ``mlp_plan.program_key``'s ``key``, built once: a copy from host memory
    to the card waits for the stream, so it is not made on every call."""
    prog = stream_plan(key).ints()
    return prog, torch.tensor(prog, dtype=torch.int32, device=device)


def _stream_key(x, wbs, num_freqs: int, backward: bool, need_dx=True,
                need_dw=True) -> tuple:
    pe = num_freqs >= 0
    return program_key(wbs[0].shape[0], _widths(wbs), x.shape[1] if pe else 0,
                       num_freqs if pe else 0, backward, need_dx, need_dw)


def stream_smem_bytes(key: tuple, backward: bool) -> int:
    """Dynamic shared memory a block of the stream kernel takes for the
    program ``key`` (-1 where the kernel rejects it): the C layout
    function, which ``mlp_plan.stream_smem`` mirrors."""
    prog = stream_plan(key).ints()
    f = "bwd" if backward else "fwd"
    return getattr(_stream_lib(), f"cropnerf_mlp_stream_{f}_smem_bytes")(
        c_ints(prog), len(prog))


def stream_forward(name, x, wbs, num_freqs: int = -1) -> torch.Tensor:
    """One launch of ``csrc/fused_mlp_stream.cu``'s forward on CUDA
    tensors (none for N = 0): the [N, Dout] float32 output.  ``num_freqs``
    >= 0: K5's variant, x [N, dim] encoded with that many frequencies into
    layer 0's input."""
    device, n = x.device, x.shape[0]
    out = torch.empty((n, wbs[-2].shape[1]), dtype=torch.float32,
                      device=device)
    if n == 0:
        return out
    key = _stream_key(x, wbs, num_freqs, False)
    prog, prog_dev = _stream_program(key, device)
    img, bias = stream_images(wbs, key)
    with torch.cuda.device(device):
        err = _stream_lib().cropnerf_mlp_stream_fwd(
            x.data_ptr(), out.data_ptr(), img.data_ptr(), bias.data_ptr(),
            c_ints(prog), prog_dev.data_ptr(), len(prog), n,
            stream_ptr(device))
    if err:
        grid = stream_fwd_grid(key, n)
        if grid["error"]:
            raise RuntimeError(cluster_refusal(
                name, err, grid, stream_smem_bytes(key, False)))
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def stream_backward(name, x, wbs, g, need_dx, need_dw, num_freqs: int = -1):
    """One launch of ``csrc/fused_mlp_stream.cu``'s backward on checked
    CUDA tensors, and its weight-gradient pass (none for N = 0): (dx or
    None, [dW0, db0, ...] in the shapes of ``wbs`` or None) in float32.
    ``num_freqs`` >= 0: K5's variant, x and dx [N, dim]."""
    device, n = x.device, x.shape[0]
    key = _stream_key(x, wbs, num_freqs, True, need_dx, need_dw)
    prog, prog_dev = _stream_program(key, device)
    lib = _stream_lib()
    sizes = (ctypes.c_longlong * 6)()
    rc = lib.cropnerf_mlp_stream_bwd_sizes(c_ints(prog), len(prog), n, sizes)
    if rc == -1:
        raise ValueError(f"{name}: the stream kernel rejects this net")
    if rc:
        raise RuntimeError(f"{name}: the device query failed: cudaError {rc}")
    ws_n, mask_n, bpart_n, wpart_n, total_w, total_b = list(sizes)
    f32 = dict(dtype=torch.float32, device=device)
    dx = torch.empty_like(x) if need_dx else None
    dw = db = ws = masks = bpart = wpart = None
    if need_dw:
        dw, db = torch.zeros((total_w,), **f32), torch.zeros((total_b,), **f32)
    if n:
        img, bias = stream_images(wbs, key)
        if mask_n:
            masks = torch.empty((mask_n,), dtype=torch.int32, device=device)
        if need_dw:
            ws = torch.empty((ws_n,), dtype=torch.bfloat16, device=device)
            bpart, wpart = (torch.empty((bpart_n,), **f32),
                            torch.empty((wpart_n,), **f32))
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(device):
            err = lib.cropnerf_mlp_stream_bwd(
                x.data_ptr(), g.data_ptr(), ptr(dx), img.data_ptr(),
                bias.data_ptr(), c_ints(prog), prog_dev.data_ptr(), len(prog),
                n, ptr(ws), ptr(masks), ptr(bpart), ptr(wpart), ptr(dw),
                ptr(db), stream_ptr(device))
        if err:
            grid = stream_bwd_grid(key, n)
            if grid["error"]:
                raise RuntimeError(cluster_refusal(
                    name, err, grid, stream_smem_bytes(key, True)))
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{err}")
    return dx, (unpack_stream_grads(wbs, dw, db) if need_dw else None)


def unpack_stream_grads(wbs: Sequence[torch.Tensor], dw: torch.Tensor,
                        db: torch.Tensor) -> list:
    """The stream backward's packed f32 gradients (``common.pack_layers``'
    layout) → [dW0, db0, ...] in the shapes of ``wbs``."""
    descs = [v for l in stream_layers(wbs[0].shape[0], _widths(wbs))
             for v in l]
    return [t for ws, db_l in unpack_layers(_layers(wbs), dw, db, descs)
            for t in (*ws, db_l)]


def fused_mlp_stream(x: torch.Tensor, wbs: Sequence[torch.Tensor]
                     ) -> torch.Tensor:
    """The "stream" route's forward on CUDA tensors
    (``csrc/fused_mlp_stream.cu``; one launch, none for N = 0)."""
    out = stream_forward("fused_mlp", x, wbs)
    if x.shape[0]:
        fused_mlp_stream.launches += 1
    return out


@torch.no_grad()
def fused_mlp_stream_bwd(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                         g: torch.Tensor, need_dx: bool = True,
                         need_dw: bool = True):
    """The "stream" route's backward on CUDA tensors
    (``csrc/fused_mlp_stream.cu``): as ``fused_mlp_bwd``."""
    out = stream_backward("fused_mlp_bwd", x, wbs, g, need_dx, need_dw)
    if x.shape[0]:
        fused_mlp_stream_bwd.launches += 1
    return out


@torch.no_grad()
def fused_mlp_bwd(x: torch.Tensor, wbs: Sequence[torch.Tensor],
                  g: torch.Tensor, need_dx: bool = True,
                  need_dw: bool = True, images=None):
    """The backward kernel of ``fused_mlp`` on CUDA tensors, on the route
    the net's shape picks: the cotangent g [N, Dout] → (dx [N, Din] or
    None, [dW0, db0, dW1, db1, ...] in the shapes of ``wbs`` or None) in
    float32.  It recomputes the forward.  ``images``: the (image, bias) of
    ``mlp_images`` for ``wbs`` where the caller has them (the forward's),
    else built here."""
    check_kernel_call("fused_mlp_bwd", [x, g, *wbs], torch.bfloat16)
    check_rows("x", x)
    n = x.shape[0]
    check_rows("g", g, n=n, cols=wbs[-2].shape[1])
    if not (need_dx or need_dw):
        raise ValueError("fused_mlp_bwd: nothing asked for")
    if _route(x, wbs) == "stream":
        return fused_mlp_stream_bwd(x, wbs, g, need_dx, need_dw)
    out = wgmma_backward("fused_mlp_bwd", x, wbs, g, need_dx, need_dw,
                         images)
    if n:
        fused_mlp_bwd.launches += 1
    return out


def wgmma_backward(name, x, wbs, g, need_dx, need_dw, images=None,
                   num_freqs: int = -1):
    """One launch of ``csrc/fused_mlp_bwd.cu`` on checked CUDA tensors and
    its weight-gradient sums (none for N = 0): (dx or None, [dW0, db0,
    ...] in the shapes of ``wbs`` or None) in float32, on ``images`` or
    ``mlp_images`` built here.  ``num_freqs`` >= 0: the PE variant, x and
    dx [N, 3], x encoded with that many frequencies into layer 0's input;
    with weight gradients on ``csrc/fused_pe_mlp_wide_bwd.cu``."""
    device, n, din = x.device, x.shape[0], wbs[0].shape[0]
    dout, n_layers, hw = wbs[-2].shape[1], len(wbs) // 2, _hidden(wbs)
    pe = num_freqs >= 0
    img_elems, n_bias, total_w, total_b, _, wgs, w_rows = mlp_layout(
        din, dout, n_layers, hw, need_dw, pe)[:7]
    img, bias = images if images is not None else mlp_images(wbs)
    check_images(name, img, bias, (img_elems,), n_bias)
    blocks = persistent_blocks(n, sm_count(device), wgs)
    dx = torch.empty_like(x) if need_dx else None
    ptrs = [None] * 4
    if need_dw:
        dw = torch.zeros((total_w,), dtype=torch.float32, device=device)
        db = torch.zeros((total_b,), dtype=torch.float32, device=device)
        # K3's wider nets' warpgroups add each tile into their own row;
        # every other kernel writes its rows whole
        wpart = (torch.zeros if hw != WGMMA_HIDDEN and not pe else
                 torch.empty)((blocks * w_rows * total_w,),
                              dtype=torch.float32, device=device)
        bpart = torch.empty((blocks * total_b,), dtype=torch.float32,
                            device=device)
        ptrs = [t.data_ptr() for t in (wpart, bpart, dw, db)]
    if n:
        lib, entry = _bwd_entry(need_dw, pe)
        with torch.cuda.device(device):
            err = getattr(lib, entry)(
                x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
                img.data_ptr(), bias.data_ptr(), din, dout, n_layers, hw,
                num_freqs, n, blocks, *ptrs, stream_ptr(device))
        if err:
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{err}")
    return dx, (unpack_images_grads(wbs, dw, db) if need_dw else None)


def unpack_images_grads(wbs: Sequence[torch.Tensor], dw: torch.Tensor,
                        db: torch.Tensor) -> list:
    """The wgmma backward's padded f32 gradients (layer l's weight [K,
    width] at its forward image's offset, its bias at l·H, H the net's
    padded hidden width) → [dW0, db0, ...] in the shapes of ``wbs``."""
    n_layers, kp, hw = len(wbs) // 2, pad16(wbs[0].shape[0]), _hidden(wbs)
    out, w_off = [], 0
    for l in range(n_layers):
        w, b = wbs[2 * l], wbs[2 * l + 1]
        k = kp if l == 0 else hw
        width = WGMMA_OUT if l == n_layers - 1 else hw
        out.append(dw[w_off:w_off + k * width].reshape(k, width)
                   [:w.shape[0], :w.shape[1]])
        out.append(db[l * hw:l * hw + b.numel()].reshape(b.shape))
        w_off += k * width
    return out


class _FusedMlp(torch.autograd.Function):
    """Forward kernel, and the backward kernel as its gradient, on the
    route the net's shape picks.  Saves x and the weights, as the JAX
    custom VJP does, and on the wgmma route the weight images the forward
    built, which the backward reads too: all through ``save_for_backward``,
    so that a checkpoint's hooks drop the images with the rest and its
    replay builds them again."""

    @staticmethod
    def forward(ctx, x, *wbs):
        ctx.n_wbs = len(wbs)
        if _route(x, wbs) == "stream":
            ctx.save_for_backward(x, *wbs)
            return fused_mlp_stream(x, wbs)
        images = mlp_images(wbs)
        ctx.save_for_backward(x, *wbs, *images)
        return _wgmma_forward(x, wbs, *images)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        wbs, images = rest[:ctx.n_wbs], rest[ctx.n_wbs:] or None
        need_dx = ctx.needs_input_grad[0]
        need_dw = any(ctx.needs_input_grad[1:])
        dx, dwbs = fused_mlp_bwd(x, wbs, g.contiguous(), need_dx, need_dw,
                                 images)
        return (dx, *(dwbs if need_dw else [None] * len(wbs)))


def _fused_mlp_card(x, wbs) -> torch.Tensor:
    """``fused_mlp`` on checked CUDA tensors: where a graph is recorded,
    the autograd function above; else the forward kernel of the net's
    route alone, on the wgmma route with the forward half of the images."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *wbs)):
        return _FusedMlp.apply(x, *wbs)
    if _route(x, wbs) == "stream":
        return fused_mlp_stream(x, wbs)
    return _wgmma_forward(x, wbs, *mlp_images(wbs, backward=False))


def fused_mlp(x: torch.Tensor, wbs: Sequence[torch.Tensor],
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, Din] float32 → [N, Dout] float32 through the relu MLP
    wbs = [W0, b0, W1, b1, ...] (W [in, out], b [1, out] or [out]),
    differentiable in x and the weights.  On the card the kernels of the
    route the net's shape picks (``fused_mlp_route``)."""
    if len(wbs) < 2 or len(wbs) % 2:
        raise ValueError("wbs must be [W0, b0, W1, b1, ...]")
    check_rows("x", x)
    k = x.shape[1]
    for w in wbs[0::2]:
        if w.dim() != 2 or w.shape[0] != k:
            raise ValueError(f"weight {tuple(w.shape)} does not take width {k}")
        k = w.shape[1]
    if x.device.type == "cpu":
        return fused_mlp_plain(x, wbs, compute_dtype)
    check_kernel_call("fused_mlp", [x, *wbs], compute_dtype)
    return _fused_mlp_card(x, wbs)


fused_mlp.launches = 0
fused_mlp_stream.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_stream_bwd.launches = 0
