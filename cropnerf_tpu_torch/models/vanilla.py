"""Vanilla (positional-encoding MLP) semantic NeRF field (counterpart of
``cropnerf_tpu/models/vanilla.py``): position encoding (10 frequencies) →
4-layer relu base → skip [h, enc] → 4-layer top → [density | geo]; a colour
head on [geo, direction encoding (4), appearance] and a semantic head on
geo.  With ``mlp_impl="pallas-fused"`` the trunk runs in the fused PE-field
kernels and the heads in the fused MLP kernel.  The appearance row is the
ray's camera's in train mode, the mean (or zero) row otherwise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core import spatial
from ..ops.activations import trunc_exp
from ..ops.cuda.fused_pe_field import fused_pe_density, fused_pe_nerf
from ..ops.mlp import MLP, mlp_apply, mlp_init
from ..ops.posenc import nerf_encoding
from .config import FieldConfig

POS_FREQS = 10
DIR_FREQS = 4


class VanillaField(nn.Module):
    def __init__(self, mlp_base: MLP, mlp_top: MLP, mlp_color: MLP,
                 mlp_semantic: MLP, appearance: Optional[torch.Tensor]):
        super().__init__()
        self.mlp_base = mlp_base
        self.mlp_top = mlp_top
        self.mlp_color = mlp_color
        self.mlp_semantic = mlp_semantic
        self.appearance = (None if appearance is None
                           else nn.Parameter(appearance))


def vanilla_field_init(cfg: FieldConfig, num_images: int,
                       generator: torch.Generator,
                       device: torch.device | str = "cpu") -> VanillaField:
    pos_dim = 3 * (2 * POS_FREQS + 1)
    dir_dim = 3 * (2 * DIR_FREQS + 1)
    hidden = max(cfg.hidden_dim, 64)
    appearance = None
    if cfg.appearance_embedding_dim:
        appearance = 0.1 * torch.randn(
            (num_images, cfg.appearance_embedding_dim), generator=generator,
            device=generator.device).to(device)
    return VanillaField(
        mlp_base=mlp_init(pos_dim, hidden, hidden, 4, generator, device),
        mlp_top=mlp_init(hidden + pos_dim, hidden, 1 + cfg.geo_feat_dim, 4,
                         generator, device),
        mlp_color=mlp_init(
            cfg.geo_feat_dim + dir_dim + cfg.appearance_embedding_dim,
            cfg.hidden_dim_color, 3, 2, generator, device),
        mlp_semantic=mlp_init(cfg.geo_feat_dim, cfg.hidden_dim_semantics,
                              cfg.num_semantic_classes,
                              cfg.num_layers_semantic, generator, device),
        appearance=appearance)


def _encoder_input(positions: torch.Tensor, cfg: FieldConfig,
                   aabb: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x = unit*2-1 in the encoder domain, in-box selector)."""
    unit, selector = spatial.to_unit(positions, cfg.use_contraction, aabb)
    return unit * 2.0 - 1.0, selector


def _wbs(mlp: MLP):
    out = []
    for w, b in zip(mlp.w, mlp.b):
        out += [w, b.reshape(1, -1)]
    return out


def vanilla_field_density(field: VanillaField, positions: torch.Tensor,
                          cfg: FieldConfig,
                          aabb: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., 3] → (density [...], geo [..., G])."""
    x, selector = _encoder_input(positions, cfg, aabb)
    if cfg.mlp_impl == "pallas-fused":
        h = fused_pe_density(x.reshape(-1, 3).contiguous(),
                             _wbs(field.mlp_base), _wbs(field.mlp_top),
                             POS_FREQS, compute_dtype)
        h = h.reshape(*x.shape[:-1], h.shape[-1])
    else:
        enc = nerf_encoding(x, POS_FREQS)
        h = mlp_apply(field.mlp_base, enc, output_activation=torch.relu,
                      compute_dtype=compute_dtype, impl=cfg.mlp_impl)
        h = mlp_apply(field.mlp_top, torch.cat([h, enc], dim=-1),
                      compute_dtype=compute_dtype, impl=cfg.mlp_impl)
    density = trunc_exp(h[..., 0]) * selector
    return density, h[..., 1:]


def appearance_rows(field: VanillaField, camera_idx: torch.Tensor,
                    cfg: FieldConfig, train: bool) -> Optional[torch.Tensor]:
    if not cfg.appearance_embedding_dim:
        return None
    table = field.appearance
    if train:
        return table[camera_idx]
    if cfg.use_average_appearance_embedding:
        return table.mean(dim=0).expand(camera_idx.shape[0], table.shape[1])
    return torch.zeros((camera_idx.shape[0], table.shape[1]),
                       device=table.device)


def vanilla_field_rgb(field: VanillaField, geo: torch.Tensor,
                      directions: torch.Tensor, camera_idx: torch.Tensor,
                      cfg: FieldConfig, train: bool,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """geo [R, S, G], directions [R, 3], camera_idx [R] → rgb [R, S, 3]."""
    enc = nerf_encoding(directions, DIR_FREQS)
    parts = [geo, enc[..., None, :].expand(*geo.shape[:-1], enc.shape[-1])]
    app = appearance_rows(field, camera_idx, cfg, train)
    if app is not None:
        parts.append(app[..., None, :].expand(*geo.shape[:-1], app.shape[-1]))
    return mlp_apply(field.mlp_color, torch.cat(parts, dim=-1),
                     output_activation=torch.sigmoid,
                     compute_dtype=compute_dtype, impl=cfg.mlp_impl)


def vanilla_field_semantics(field: VanillaField, geo: torch.Tensor,
                            cfg: FieldConfig,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            pass_gradients: bool = False) -> torch.Tensor:
    """Semantic logits [..., C] from geo features, detached from the
    density branch unless ``pass_gradients``."""
    if not pass_gradients:
        geo = geo.detach()
    return mlp_apply(field.mlp_semantic, geo, compute_dtype=compute_dtype,
                     impl=cfg.mlp_impl)


def fused_field_weights(field: VanillaField, cfg: FieldConfig):
    """(base_wbs, top_wbs, color_wbs, sem_wbs) as ``fused_pe_nerf`` takes
    them.  The head layer-0 weights get a zero top row, so the kernel
    contracts the whole trunk output [density_raw | geo] against them."""
    G = cfg.geo_feat_dim
    wc0 = field.mlp_color.w[0]
    color_wbs = ([F.pad(wc0[:G], (0, 0, 1, 0)), wc0[G:],
                  field.mlp_color.b[0].reshape(1, -1)]
                 + _wbs(field.mlp_color)[2:])
    sem_wbs = ([F.pad(field.mlp_semantic.w[0], (0, 0, 1, 0)),
                field.mlp_semantic.b[0].reshape(1, -1)]
               + _wbs(field.mlp_semantic)[2:])
    return _wbs(field.mlp_base), _wbs(field.mlp_top), color_wbs, sem_wbs


def vanilla_field_all(field: VanillaField, positions: torch.Tensor,
                      directions: torch.Tensor, camera_idx: torch.Tensor,
                      cfg: FieldConfig, train: bool,
                      aabb: Optional[torch.Tensor] = None,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      pass_sem_grads: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(density, rgb, semantic logits) in one pass; with
    ``mlp_impl="pallas-fused"`` one ``fused_pe_nerf`` call, otherwise the
    three split functions.  The semantic head's gradient reaches the trunk
    only with ``pass_sem_grads``."""
    if cfg.mlp_impl != "pallas-fused":
        density, geo = vanilla_field_density(field, positions, cfg, aabb,
                                             compute_dtype)
        rgb = vanilla_field_rgb(field, geo, directions, camera_idx, cfg,
                                train, compute_dtype)
        sem = vanilla_field_semantics(field, geo, cfg, compute_dtype,
                                      pass_sem_grads)
        return density, rgb, sem

    x, selector = _encoder_input(positions, cfg, aabb)
    batch_shape = x.shape[:-1]

    # per-ray colour-head extras (direction encoding ‖ appearance row),
    # broadcast over the samples: the kernel's one O(N·De) input
    enc_d = nerf_encoding(directions, DIR_FREQS)
    app = appearance_rows(field, camera_idx, cfg, train)
    ray_extras = enc_d if app is None else torch.cat([enc_d, app], dim=-1)
    extras = ray_extras[..., None, :].expand(*batch_shape,
                                             ray_extras.shape[-1])

    base_wbs, top_wbs, color_wbs, sem_wbs = fused_field_weights(field, cfg)
    t, rgb_raw, sem_raw = fused_pe_nerf(
        x.reshape(-1, 3).contiguous(),
        extras.reshape(-1, extras.shape[-1]).contiguous(),
        base_wbs, top_wbs, color_wbs, sem_wbs, POS_FREQS, compute_dtype,
        pass_sem_grads)
    t = t.reshape(*batch_shape, t.shape[-1])
    density = trunc_exp(t[..., 0]) * selector
    rgb = torch.sigmoid(rgb_raw).reshape(*batch_shape, rgb_raw.shape[-1])
    sem = sem_raw.reshape(*batch_shape, sem_raw.shape[-1])
    return density, rgb, sem
