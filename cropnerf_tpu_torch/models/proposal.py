"""Proposal density nets (counterpart of ``cropnerf_tpu/models/proposal.py``):
the positional-encoding branch."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import spatial
from ..ops.activations import trunc_exp
from ..ops.mlp import MLP, mlp_apply, mlp_init
from ..ops.posenc import nerf_encoding
from .config import ProposalFieldConfig

HASH_NOT_PORTED = ("hash-grid proposal nets are not ported yet (hash-grid "
                   "family slice: ops/hashgrid.py and the hash_encode kernel)")


class ProposalField(nn.Module):
    """PE proposal net: one MLP on the encoding of the position."""

    def __init__(self, mlp: MLP):
        super().__init__()
        self.mlp = mlp


def proposal_init(cfg: ProposalFieldConfig, generator: torch.Generator,
                  device: torch.device | str = "cpu") -> ProposalField:
    if cfg.field_type != "pe":
        raise NotImplementedError(HASH_NOT_PORTED)
    num_layers = 1 if cfg.use_linear else cfg.num_layers
    pe_dim = 3 * (2 * cfg.pe_freqs + 1)
    return ProposalField(mlp_init(pe_dim, cfg.hidden_dim, 1,
                                  max(num_layers, 2), generator, device))


def proposal_density(prop: ProposalField, positions: torch.Tensor,
                     cfg: ProposalFieldConfig, use_contraction: bool = True,
                     aabb: Optional[torch.Tensor] = None,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """positions [..., 3] world → density [...]."""
    if cfg.field_type != "pe":
        raise NotImplementedError(HASH_NOT_PORTED)
    if cfg.mlp_impl == "pallas-fused":
        raise NotImplementedError(
            "the fused PE + MLP proposal kernel (fused_pe_mlp) is not "
            "ported yet; use mlp_impl='xla' or 'pallas'")
    if use_contraction:
        unit = spatial.contracted_to_unit(positions)
    else:
        if aabb is None:
            raise ValueError("use_contraction=False needs an aabb")
        unit = spatial.aabb_to_unit(positions, aabb)
    selector = spatial.unit_selector(unit)
    unit = unit * selector[..., None]
    enc = nerf_encoding(unit * 2.0 - 1.0, cfg.pe_freqs)
    h = mlp_apply(prop.mlp, enc, compute_dtype=compute_dtype,
                  impl=cfg.mlp_impl)
    return trunc_exp(h[..., 0]) * selector
