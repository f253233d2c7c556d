"""Post-hoc spatial uncertainty (BayesRays), adapted to the semantic head
(counterpart of ``cropnerf_tpu/uncertainty/bayesrays.py``).

A virtual deformation field u(x) on a dense (2^lod+1)^3 grid perturbs the
sample positions; the Laplace-approximation Hessian diagonal is accumulated
as, per ray r and grid corner g,

    H[g] += sum_d ( sum_{points p in r} w_{g,p} * dL_r/d u_d(x_p) )^2

with w the trilinear weights.  One ray batch differentiates the rendered
channel with respect to injected position offsets; the field's parameters
need no gradient, so on the card the kernels' backwards compute dx alone
(the ``fused_pe_density`` and ``fused_mlp`` backwards of ``cropnerf-mxu``,
the ``hash_encode`` backward's position gradient of ``cropnerf``).

The per-(ray, corner) sums are a sort-based segment reduction: one int64
key cell·R + ray (a combined key fits: 16,974,593 cells × 4096 rays at
lod 8 is ~7e10), a stable sort, ``segment_reduce`` over the (ray, cell)
runs, the squares summed over each cell's runs, and one write per touched
cell.  No atomics, so the grid is the same bits from run to run; it
differs from the JAX module's only by summation order.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import spatial
from ..core.cameras import generate_rays, near_far_collider
from ..core.rays import RayBundle
from ..data.databank import PixelBank, decode_pixel_index
from ..models.config import ModelConfig
from ..models.field import field_density, field_rgb, field_semantics
from ..models.model import CropNeRFParams, _proposal_sampling
from ..ops import render as render_ops


def normalize_points(points: torch.Tensor, cfg: ModelConfig,
                     aabb: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World → [0,1]^3 (zeroed outside) and the in-cube selector."""
    return spatial.to_unit(points, cfg.field.use_contraction, aabb)


def grid_corner_indices(pos_unit: torch.Tensor, selector: torch.Tensor,
                        lod: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """8-corner flat indices and trilinear coefficients of positions
    ``pos_unit`` [P, 3] in [0, 1]: (inds [8, P] int64, coeffs [8, P]).

    A coordinate of exactly 1 has base corner 2^lod, so its far corner's
    index can pass the grid's (2^lod+1)^3 cells; its coefficient is 0.  The
    callers drop such an index where they scatter and clamp it where they
    gather, as the JAX module's ``.at[].add`` and indexing do.  The index
    is exact integer arithmetic (the JAX module rounds it through float32,
    which at lod 8 moves indices above 2^24 to an even neighbour)."""
    res = 2 ** lod
    coords = pos_unit * res
    base = torch.floor(coords)
    frac = coords - base
    b = base.long()
    side = res + 1
    inds, coeffs = [], []
    for corner in range(8):
        dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        inds.append((b[:, 0] + dx) * side * side + (b[:, 1] + dy) * side
                    + (b[:, 2] + dz))
        w = ((frac[:, 0] - (1 - dx)).abs() * (frac[:, 1] - (1 - dy)).abs()
             * (frac[:, 2] - (1 - dz)).abs())
        coeffs.append(w * selector)
    return torch.stack(inds), torch.stack(coeffs)


def _segment_hessian(grads, inds: torch.Tensor, coeffs: torch.Tensor,
                     n_rays: int, n_cells: int) -> torch.Tensor:
    """Σ over channels of Σ_d (Σ_{p in r} w_{g,p} grad_d(p))², summed over
    the rays, into a dense [n_cells] grid.  ``grads`` are per-channel
    [P, 3] position gradients, P = n_rays · samples per ray, ray-major."""
    n_pts = inds.shape[1]
    ray = torch.arange(n_rays, device=inds.device).repeat_interleave(
        n_pts // n_rays)
    keep = (inds < n_cells).reshape(-1)
    keys = (inds * n_rays + ray).reshape(-1)[keep]
    order = torch.argsort(keys, stable=True)
    run_keys, run_len = torch.unique_consecutive(keys[order],
                                                 return_counts=True)
    cells, cell_len = torch.unique_consecutive(run_keys // n_rays,
                                               return_counts=True)
    per_cell = torch.zeros(cells.shape, device=inds.device)
    for g in grads:
        vals = (coeffs[:, :, None] * g[None]).reshape(-1, 3)[keep][order]
        per_run = torch.segment_reduce(vals, "sum", lengths=run_len)
        per_cell = per_cell + torch.segment_reduce(
            (per_run ** 2).sum(dim=-1), "sum", lengths=cell_len)
    hessian = torch.zeros((n_cells,), device=inds.device)
    hessian[cells] = per_cell
    return hessian


def _hessian_batch(params: CropNeRFParams, rb: RayBundle, cfg: ModelConfig,
                   lod: int, channel: str,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """One ray batch → its dense Hessian grid contribution
    [(2^lod+1)^3].  ``semantics`` differentiates the rendered class-0
    logit sum; ``rgb`` the three colour sums, one gradient each."""
    with torch.no_grad():
        samples, _, _ = _proposal_sampling(params, rb, cfg, False, 1.0,
                                           compute_dtype=compute_dtype)
    positions = samples.positions                      # [R, S, 3]
    n_rays = positions.shape[0]
    offsets = torch.zeros_like(positions, requires_grad=True)
    with torch.enable_grad():
        density, geo = field_density(params.field, positions + offsets,
                                     cfg.field, compute_dtype=compute_dtype)
        weights = render_ops.render_weights(density, samples.deltas)
        if channel == "semantics":
            vals = field_semantics(params.field, geo, cfg.field,
                                   compute_dtype, pass_gradients=True)
        else:
            vals = field_rgb(params.field, geo, samples.directions,
                             samples.camera_idx, cfg.field, train=False,
                             compute_dtype=compute_dtype)
        out = render_ops.accumulate(weights, vals).sum(dim=0)   # [C]
        outs = [out[0]] if channel == "semantics" else list(out)
        grads = [torch.autograd.grad(o, offsets,
                                     retain_graph=i < len(outs) - 1)[0]
                 .reshape(-1, 3) for i, o in enumerate(outs)]
    pos_unit, selector = normalize_points(positions, cfg)
    inds, coeffs = grid_corner_indices(pos_unit.reshape(-1, 3),
                                       selector.reshape(-1), lod)
    return _segment_hessian(grads, inds, coeffs, n_rays,
                            (2 ** lod + 1) ** 3)


@contextlib.contextmanager
def _no_param_grads(params: torch.nn.Module):
    """Parameters without ``requires_grad`` for the block, so the kernels'
    backwards skip the weight gradients; restored after."""
    flags = [(p, p.requires_grad) for p in params.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


class ComputeUncertainty:
    """Accumulates the Hessian grid over ray batches (the BayesRays
    ``uncertainty`` pass)."""

    def __init__(self, params: CropNeRFParams, cfg: ModelConfig,
                 lod: int = 8, channel: str = "semantics",
                 compute_dtype: torch.dtype = torch.bfloat16):
        if channel not in ("semantics", "rgb"):
            raise ValueError(f"channel {channel!r}: 'semantics' or 'rgb'")
        self.params = params
        self.cfg = cfg
        self.lod = lod
        self.channel = channel
        self.compute_dtype = compute_dtype

    def batch(self, rb: RayBundle) -> torch.Tensor:
        """One ray batch's grid contribution, on the batch's device."""
        with _no_param_grads(self.params):
            return _hessian_batch(self.params, rb, self.cfg, self.lod,
                                  self.channel, self.compute_dtype)

    def run(self, ray_batches: Iterable[RayBundle],
            save_path=None) -> np.ndarray:
        """Accumulate over ``ray_batches`` and return the Hessian grid
        [(2^lod+1)^3] float32 as numpy (saved as ``unc.npy`` when
        ``save_path`` is given, the JAX package's format)."""
        hessian = None
        for rb in ray_batches:
            h = self.batch(rb)
            hessian = h if hessian is None else hessian + h
        hessian = hessian.cpu().numpy()
        if save_path is not None:
            np.save(save_path, hessian)
        return hessian


def bank_ray_batches(bank: PixelBank, cfg: ModelConfig, iters: int,
                     rays_per_batch: int, generator: torch.Generator
                     ) -> Iterator[RayBundle]:
    """``iters`` bundles of ``rays_per_batch`` random pixels of the bank,
    drawn from ``generator``, with the near/far collider applied: the ray
    source of the ``uncertainty`` command."""
    for _ in range(iters):
        idx = torch.randint(0, bank.num_pixels, (rays_per_batch,),
                            generator=generator, device=generator.device)
        cam, px, py = decode_pixel_index(idx.to(bank.rgb.device),
                                         bank.height, bank.width)
        origins, dirs = generate_rays(bank.cameras, cam, px, py)
        rb = RayBundle(origins=origins, directions=dirs,
                       nears=torch.zeros_like(origins[:, 0]),
                       fars=torch.ones_like(origins[:, 0]), camera_idx=cam)
        yield near_far_collider(rb, cfg.near_plane, cfg.far_plane)


# Fixed global log10 normalisation bounds: uncertainty is an absolute
# quantity, so a filter threshold means the same in every render chunk.
UNC_LOG_MIN = -3.0
UNC_LOG_MAX = 6.0


def uncertainty_at(points: torch.Tensor, hessian, cfg: ModelConfig,
                   lod: int, n_samples: int, lambda_reg: float = 1e-4
                   ) -> torch.Tensor:
    """Pointwise uncertainty 1/(H/N + λ), trilinearly interpolated from the
    grid and log10-rescaled to [0, 1] against the fixed bounds
    [UNC_LOG_MIN, UNC_LOG_MAX].  ``hessian`` is the grid (numpy or a
    tensor)."""
    hessian = torch.as_tensor(hessian, device=points.device)
    shape = points.shape[:-1]
    pos_unit, selector = normalize_points(points.reshape(-1, 3), cfg)
    inds, coeffs = grid_corner_indices(pos_unit, selector, lod)
    inds = inds.clamp(max=hessian.shape[0] - 1)
    h = torch.zeros(pos_unit.shape[0], device=points.device)
    for corner in range(8):
        h = h + hessian[inds[corner]] * coeffs[corner]
    unc = torch.log10(1.0 / (h / n_samples + lambda_reg) + 1e-12)
    unc = ((unc.clamp(UNC_LOG_MIN, UNC_LOG_MAX) - UNC_LOG_MIN)
           / (UNC_LOG_MAX - UNC_LOG_MIN))
    return unc.reshape(shape)


def make_uncertainty_density_hook(hessian, cfg: ModelConfig, lod: int,
                                  n_samples: int, lambda_reg: float = 1e-4
                                  ) -> Callable:
    """Density post-filter for the uncertainty-filtered render: zero the
    density wherever pointwise uncertainty exceeds the threshold.  Returns
    ``hook(positions, density, threshold) -> density`` for
    :func:`cropnerf_tpu_torch.train.step.make_render_fn` (whose
    ``hook_arg`` is the threshold)."""
    grids = {}

    def hook(positions, density, threshold):
        dev = positions.device
        if dev not in grids:
            grids[dev] = torch.as_tensor(hessian, device=dev)
        unc = uncertainty_at(positions, grids[dev], cfg, lod, n_samples,
                             lambda_reg)
        return torch.where(unc <= threshold, density, 0.0)

    return hook


@torch.no_grad()
def render_uncertainty(params: CropNeRFParams, rb: RayBundle,
                       cfg: ModelConfig, hessian, lod: int, n_samples: int,
                       lambda_reg: float = 1e-4,
                       density_threshold: Optional[float] = None,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Per-ray uncertainty [R]: the weight-accumulated pointwise
    uncertainty, with the density zeroed below ``density_threshold`` when
    given."""
    samples, _, _ = _proposal_sampling(params, rb, cfg, False, 1.0,
                                       compute_dtype=compute_dtype)
    positions = samples.positions
    density, _ = field_density(params.field, positions, cfg.field,
                               compute_dtype=compute_dtype)
    if density_threshold is not None:
        density = torch.where(density >= density_threshold, density, 0.0)
    weights = render_ops.render_weights(density, samples.deltas)
    unc = uncertainty_at(positions, hessian, cfg, lod, n_samples, lambda_reg)
    return (weights * unc).sum(dim=-1)
