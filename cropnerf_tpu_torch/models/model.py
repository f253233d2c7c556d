"""CropNeRF model: proposal-sampled semantic NeRF (counterpart of
``cropnerf_tpu/models/model.py``).

  * :func:`forward`              full composited forward (train or eval)
  * :func:`forward_export`       raw per-sample queries for volume export
  * :func:`forward_accumulation` accumulated weight per ray (visibility)
  * :func:`anneal_factor`, :func:`_proposal_sampling` proposal sampling

The parameters are a :class:`CropNeRFParams` module whose tree mirrors the
JAX params pytree: ``field``, ``camera_opt`` and ``proposal_{i}``.
``forward(train=True)`` records the autograd graph the training step
differentiates; ``forward(train=False)`` and the export entry points run
without one, whatever the caller's grad mode.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.rays import RayBundle, RaySamples
from ..device import resolve_device
from ..ops import pdf as pdf_ops
from ..ops import render as render_ops
from .camera_opt import apply_to_raybundle, camera_opt_init
from .config import ModelConfig
from .field import (Field, field_all, field_density, field_init, field_rgb,
                    field_semantics)
from .proposal import ProposalField, proposal_density, proposal_init


class CropNeRFParams(nn.Module):
    """The params tree: ``field`` (hash-grid or vanilla), ``camera_opt``
    [num_images, 6] SO3xR3 tangent deltas, and one ``proposal_{i}`` per
    proposal net."""

    def __init__(self, field: Field, camera_opt: torch.Tensor,
                 proposals: List[ProposalField]):
        super().__init__()
        self.field = field
        self.camera_opt = nn.Parameter(camera_opt)
        for i, p in enumerate(proposals):
            self.add_module(f"proposal_{i}", p)
        self.num_proposals = len(proposals)

    def proposal(self, i: int) -> ProposalField:
        return getattr(self, f"proposal_{i}")


def model_init(cfg: ModelConfig, num_images: int,
               generator: torch.Generator,
               device: torch.device | str = "cuda") -> CropNeRFParams:
    """Random parameters drawn from ``generator``, placed on ``device``."""
    device = resolve_device(device)
    field = field_init(cfg.field, num_images, generator, device)
    props = [proposal_init(p, generator, device) for p in cfg.proposal_fields]
    return CropNeRFParams(field, camera_opt_init(num_images, device), props)


def anneal_factor(step: torch.Tensor | int, cfg: ModelConfig) -> torch.Tensor:
    """Proposal-weight annealing: bias(x, s) = s·x / ((s-1)·x + 1) with
    x = step / anneal_max_num_iters clipped to [0, 1]."""
    x = (torch.as_tensor(step, dtype=torch.float32)
         / cfg.proposal_weights_anneal_max_num_iters).clamp(0.0, 1.0)
    s = cfg.proposal_weights_anneal_slope
    return s * x / ((s - 1.0) * x + 1.0)


def _sdist(samples: RaySamples) -> torch.Tensor:
    return torch.cat([samples.spacing_starts, samples.spacing_ends[..., -1:]],
                     dim=-1)


def _proposal_sampling(params: CropNeRFParams, rb: RayBundle,
                       cfg: ModelConfig, train: bool,
                       anneal: torch.Tensor | float,
                       generator: Optional[torch.Generator] = None,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       prop_update: Optional[bool] = None,
                       density_hook: Optional[Callable] = None,
                       ) -> Tuple[RaySamples, List[torch.Tensor], List[torch.Tensor]]:
    """Hierarchical proposal sampling (nerfstudio ProposalNetworkSampler):
    (final samples, weights per proposal level, s-space bins per level).

    ``prop_update`` False runs the proposal nets without a graph: the
    counterpart of the JAX ``lax.cond`` that stops their gradients on the
    steps between proposal updates.  ``density_hook`` (positions, density)
    -> density post-processes each proposal density, so that the samplers
    avoid what an uncertainty-filtered render removes."""
    spacing = pdf_ops.spacing_piecewise()
    weights_list: List[torch.Tensor] = []
    sdist_list: List[torch.Tensor] = []
    samples = pdf_ops.sample_spaced(rb, cfg.num_proposal_samples_per_ray[0],
                                    spacing, train, cfg.use_single_jitter,
                                    generator=generator)
    n_prop = cfg.num_proposal_iterations
    frozen = prop_update is not None and not prop_update
    for i in range(n_prop):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            density = proposal_density(params.proposal(i), samples.positions,
                                       cfg.proposal_fields[i],
                                       compute_dtype=compute_dtype)
        if density_hook is not None:
            density = density_hook(samples.positions, density)
        weights = render_ops.render_weights(density, samples.deltas)
        sdist = _sdist(samples)
        weights_list.append(weights)
        sdist_list.append(sdist)
        annealed = torch.pow(weights.detach(), anneal)
        next_count = (cfg.num_proposal_samples_per_ray[i + 1]
                      if i + 1 < n_prop else cfg.num_nerf_samples_per_ray)
        samples = pdf_ops.sample_pdf(rb, sdist, annealed, next_count, spacing,
                                     train, cfg.use_single_jitter,
                                     generator=generator)
    return samples, weights_list, sdist_list


def forward(params: CropNeRFParams, ray_bundle: RayBundle, cfg: ModelConfig,
            train: bool = False, anneal: torch.Tensor | float = 1.0,
            background: Optional[str] = None,
            compute_dtype: torch.dtype = torch.bfloat16,
            generator: Optional[torch.Generator] = None,
            prop_update: Optional[bool] = None,
            density_hook: Optional[Callable] = None
            ) -> Dict[str, torch.Tensor]:
    """Full composited forward: rgb, accumulation, median depth, semantics,
    per-level weights and bins, and per-proposal expected depths.

    ``train=True`` applies the camera-opt deltas to the rays, jitters the
    samplers from ``generator`` (none: no jitter, as a JAX key of None),
    uses each ray's appearance row and records the autograd graph;
    ``train=False`` runs without a graph.  ``density_hook`` (positions,
    density) -> density post-processes every proposal density and the final
    field density (after gradient scaling): the BayesRays
    uncertainty-filtered render."""
    with torch.set_grad_enabled(train):
        return _forward(params, ray_bundle, cfg, train, anneal, background,
                        compute_dtype, generator, prop_update, density_hook)


def _forward(params, ray_bundle, cfg, train, anneal, background,
             compute_dtype, generator, prop_update, density_hook):
    rb = (apply_to_raybundle(params.camera_opt, ray_bundle,
                             cfg.camera_opt.mode) if train else ray_bundle)
    samples, weights_list, sdist_list = _proposal_sampling(
        params, rb, cfg, train, anneal, generator, compute_dtype, prop_update,
        density_hook)
    density, rgb_samples, sem_samples = field_all(
        params.field, samples.positions, samples.directions,
        samples.camera_idx, cfg.field, train, compute_dtype,
        cfg.pass_semantic_gradients)
    if cfg.use_gradient_scaling:
        # identity forward; the backward scales by clamp(t², 0, 1)
        # (nerfstudio scale_gradients_by_distance_squared)
        s = (samples.midpoints ** 2).clamp(0.0, 1.0)

        def gscale(v, s):
            return v * s + (v * (1.0 - s)).detach()

        density = gscale(density, s)
        rgb_samples = gscale(rgb_samples, s[..., None])
        sem_samples = gscale(sem_samples, s[..., None])
    if density_hook is not None:
        density = density_hook(samples.positions, density)
    weights = render_ops.render_weights(density, samples.deltas)
    weights_list = weights_list + [weights]
    sdist_list = sdist_list + [_sdist(samples)]

    bg = background or cfg.background_color
    sem_weights = weights if cfg.pass_semantic_gradients else weights.detach()
    semantics = render_ops.render_semantics(sem_weights, sem_samples)
    outputs = {
        "rgb": render_ops.render_rgb(weights, rgb_samples, background=bg),
        "accumulation": render_ops.render_accumulation(weights),
        "depth": render_ops.render_depth_median(weights.detach(),
                                                samples.midpoints),
        "semantics": semantics,
        "semantics_colormap": torch.sigmoid(semantics),
        "weights_list": weights_list,
        "sdist_list": sdist_list,
    }
    for i in range(cfg.num_proposal_iterations):
        mids = 0.5 * (sdist_list[i][..., 1:] + sdist_list[i][..., :-1])
        outputs[f"prop_depth_{i}"] = render_ops.render_depth_expected(
            weights_list[i].detach(), mids)

    if ray_bundle.mask is not None:
        m = ray_bundle.mask
        for k in ("rgb", "accumulation", "depth", "semantics",
                  "semantics_colormap"):
            outputs[k] = outputs[k] * m[..., None]
    return outputs


@torch.no_grad()
def forward_export(params: CropNeRFParams, ray_bundle: RayBundle,
                   cfg: ModelConfig, num_samples: int, aabb: torch.Tensor,
                   render_rgb_samples: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, torch.Tensor]:
    """Raw per-sample field queries for volume export: uniform sampler
    jittered by ``generator`` or ``noise`` [R, S+1] (none: bin centres).
    Returns [R, S(, C)] density, semantics, point_location (and rgb)."""
    samples = pdf_ops.sample_uniform_with_noise(
        ray_bundle, num_samples, generator=generator, noise=noise)
    pos = samples.positions
    density, geo = field_density(params.field, pos, cfg.field, aabb=aabb,
                                 compute_dtype=compute_dtype)
    semantics = field_semantics(params.field, geo, cfg.field, compute_dtype)
    out = {"density": density, "semantics": semantics[..., 0],
           "point_location": pos}
    if render_rgb_samples:
        out["rgb"] = field_rgb(params.field, geo, samples.directions,
                               samples.camera_idx, cfg.field, train=False,
                               compute_dtype=compute_dtype)
    return out


@torch.no_grad()
def forward_accumulation(params: CropNeRFParams, ray_bundle: RayBundle,
                         cfg: ModelConfig,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Accumulated density weight per ray [R] (the projection stage's
    visibility test)."""
    samples, _, _ = _proposal_sampling(params, ray_bundle, cfg, False, 1.0,
                                       compute_dtype=compute_dtype)
    density, _ = field_density(params.field, samples.positions, cfg.field,
                               compute_dtype=compute_dtype)
    acc = render_ops.render_weights(density, samples.deltas).sum(dim=-1)
    if ray_bundle.mask is not None:
        acc = acc * ray_bundle.mask
    return acc
