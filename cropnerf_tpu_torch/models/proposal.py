"""Proposal density nets (counterpart of ``cropnerf_tpu/models/proposal.py``):
a small hash grid and a narrow MLP (nerfstudio ``HashMLPDensityField``, the
presets' default), or with ``field_type="pe"`` an MLP on the positional
encoding of the position (one fused encode + MLP kernel with
``mlp_impl="pallas-fused"``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import spatial
from ..device import resolve_device
from ..ops.activations import trunc_exp
from ..ops.cuda.fused_pe_field import fused_pe_mlp
from ..ops.mlp import MLP, mlp_apply, mlp_init
from ..ops.posenc import nerf_encoding
from .config import ProposalFieldConfig
from .field import grid_features, grid_init


class ProposalField(nn.Module):
    """One MLP, on the hash-grid features of the position when ``grid`` is
    given, else on its positional encoding."""

    def __init__(self, mlp: MLP, grid: Optional[torch.Tensor] = None):
        super().__init__()
        self.grid = None if grid is None else nn.Parameter(grid)
        self.mlp = mlp


def proposal_init(cfg: ProposalFieldConfig, generator: torch.Generator,
                  device: torch.device | str = "cuda") -> ProposalField:
    """Random proposal-net parameters drawn from ``generator``, on
    ``device``."""
    device = resolve_device(device)
    num_layers = 1 if cfg.use_linear else cfg.num_layers
    if cfg.field_type == "pe":
        pe_dim = 3 * (2 * cfg.pe_freqs + 1)
        return ProposalField(mlp_init(pe_dim, cfg.hidden_dim, 1,
                                      max(num_layers, 2), generator, device))
    g = cfg.grid
    grid = grid_init(g, generator, device)
    return ProposalField(mlp_init(g.num_levels * g.features_per_level,
                                  cfg.hidden_dim, 1, num_layers, generator,
                                  device), grid)


def proposal_density(prop: ProposalField, positions: torch.Tensor,
                     cfg: ProposalFieldConfig, use_contraction: bool = True,
                     aabb: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """positions [..., 3] world → density [...]."""
    unit, selector = spatial.to_unit(positions, use_contraction, aabb)
    if cfg.field_type == "pe" and cfg.mlp_impl == "pallas-fused":
        # one kernel: encode + MLP (ops/cuda/fused_pe_field.py fused_pe_mlp)
        x = unit * 2.0 - 1.0
        wbs = []
        for w, b in zip(prop.mlp.w, prop.mlp.b):
            wbs += [w, b.reshape(1, -1)]
        h = fused_pe_mlp(x.reshape(-1, 3), wbs, cfg.pe_freqs, compute_dtype)
        h = h.reshape(*x.shape[:-1], h.shape[-1])
        return trunc_exp(h[..., 0]) * selector
    if cfg.field_type == "pe":
        feats = nerf_encoding(unit * 2.0 - 1.0, cfg.pe_freqs)
    else:
        feats = grid_features(prop.grid, unit, cfg.grid)
    h = mlp_apply(prop.mlp, feats, compute_dtype=compute_dtype,
                  impl=cfg.mlp_impl)
    return trunc_exp(h[..., 0]) * selector
