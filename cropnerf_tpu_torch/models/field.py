"""Field dispatch and the hash-grid field (counterpart of
``cropnerf_tpu/models/field.py``).

:class:`CropField` is the paper's field (FruitNeRF's nerfacto field): a
multiresolution hash grid → base MLP [L·F → 64 → 1 + 15] → density
``trunc_exp(raw) · selector`` and geo features; a colour MLP on [SH(4) of
the direction ‖ geo ‖ appearance row] with a sigmoid; a semantic MLP on
the geo features (detached unless ``pass_semantic_gradients``) with no
output activation, then a linear head.  The appearance row is the ray's
camera's in train mode, the mean row in eval.  The grid goes through the
``hash_encode`` kernels on the card; its MLPs are plain matmuls with
``mlp_impl="xla"``, as the JAX package computes them outside any Pallas
kernel.  ``field_type="vanilla"`` dispatches to :mod:`.vanilla`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core import spatial
from ..device import resolve_device
from ..ops.activations import trunc_exp
from ..ops.hashgrid import (hashgrid_encode, hashgrid_encode_plain,
                            hashgrid_init, hashgrid_init_packed,
                            level_resolutions)
from ..ops.mlp import MLP, mlp_apply, mlp_init
from ..ops.sh import sh_encoding
from .config import FieldConfig, HashGridConfig
from .vanilla import (VanillaField, appearance_rows, vanilla_field_all,
                      vanilla_field_density, vanilla_field_init,
                      vanilla_field_rgb, vanilla_field_semantics)


class CropField(nn.Module):
    """The hash-grid field's parameters, named as the JAX params tree."""

    def __init__(self, grid: torch.Tensor, mlp_base: MLP, mlp_semantic: MLP,
                 semantic_head: MLP, mlp_color: MLP,
                 appearance: torch.Tensor):
        super().__init__()
        self.grid = nn.Parameter(grid)
        self.mlp_base = mlp_base
        self.mlp_semantic = mlp_semantic
        self.semantic_head = semantic_head
        self.mlp_color = mlp_color
        self.appearance = nn.Parameter(appearance)


Field = VanillaField | CropField


def grid_init(g: HashGridConfig, generator: torch.Generator,
              device: torch.device | str) -> torch.Tensor:
    """A grid table of ``g``'s layout: packed [Σ rows_l, F] or dense
    [L, T, F]."""
    if g.layout == "packed":
        res = level_resolutions(g.num_levels, g.min_res, g.max_res)
        return hashgrid_init_packed(res, g.features_per_level,
                                    g.log2_hashmap_size, generator,
                                    device=device)
    return hashgrid_init(g.num_levels, g.features_per_level,
                         g.log2_hashmap_size, generator, device=device)


def grid_features(grid: torch.Tensor, unit: torch.Tensor,
                  g: HashGridConfig) -> torch.Tensor:
    """Encode positions in [0, 1]^3 with ``g``'s grid.  ``impl`` "xla" (the
    presets) and "pallas" both run the ``hash_encode`` kernels on the card;
    the port's own value "plain" runs :func:`hashgrid_encode_plain` on any
    device, the reference path that tests and ``chip_smoke.py`` compare
    the kernel path with."""
    res = level_resolutions(g.num_levels, g.min_res, g.max_res)
    encode = hashgrid_encode_plain if g.impl == "plain" else hashgrid_encode
    return encode(grid, unit, res, table_size=2 ** g.log2_hashmap_size,
                  cell_pack=g.cell_pack)


def field_init(cfg: FieldConfig, num_images: int, generator: torch.Generator,
               device: torch.device | str = "cuda") -> Field:
    """Random field parameters drawn from ``generator``, on ``device``."""
    device = resolve_device(device)
    if cfg.field_type == "vanilla":
        return vanilla_field_init(cfg, num_images, generator, device)
    g = cfg.grid
    grid_dim = g.num_levels * g.features_per_level
    color_in = (cfg.sh_levels ** 2 + cfg.geo_feat_dim
                + cfg.appearance_embedding_dim)
    grid = grid_init(g, generator, device)
    return CropField(
        grid=grid,
        mlp_base=mlp_init(grid_dim, cfg.hidden_dim, 1 + cfg.geo_feat_dim,
                          cfg.num_layers, generator, device),
        mlp_semantic=mlp_init(cfg.geo_feat_dim, cfg.hidden_dim_semantics,
                              cfg.hidden_dim_semantics,
                              cfg.num_layers_semantic, generator, device),
        semantic_head=mlp_init(cfg.hidden_dim_semantics, 0,
                               cfg.num_semantic_classes, 1, generator,
                               device),
        mlp_color=mlp_init(color_in, cfg.hidden_dim_color, 3,
                           cfg.num_layers_color, generator, device),
        appearance=0.1 * torch.randn(
            (num_images, cfg.appearance_embedding_dim), generator=generator,
            device=generator.device).to(device))


def field_density(field: Field, positions: torch.Tensor, cfg: FieldConfig,
                  aabb: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., 3] world → (density [...], geo [..., G])."""
    if cfg.field_type == "vanilla":
        return vanilla_field_density(field, positions, cfg, aabb,
                                     compute_dtype)
    unit, selector = spatial.to_unit(positions, cfg.use_contraction, aabb)
    feats = grid_features(field.grid, unit, cfg.grid)
    h = mlp_apply(field.mlp_base, feats, compute_dtype=compute_dtype,
                  impl=cfg.mlp_impl)
    return trunc_exp(h[..., 0]) * selector, h[..., 1:]


def field_semantics(field: Field, geo: torch.Tensor, cfg: FieldConfig,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    pass_gradients: bool = False) -> torch.Tensor:
    """Semantic logits [..., C] from geo features, detached from the
    density branch unless ``pass_gradients``."""
    if cfg.field_type == "vanilla":
        return vanilla_field_semantics(field, geo, cfg, compute_dtype,
                                       pass_gradients)
    if not pass_gradients:
        geo = geo.detach()
    h = mlp_apply(field.mlp_semantic, geo, compute_dtype=compute_dtype,
                  impl=cfg.mlp_impl)
    return mlp_apply(field.semantic_head, h, compute_dtype=compute_dtype)


def field_rgb(field: Field, geo: torch.Tensor, directions: torch.Tensor,
              camera_idx: torch.Tensor, cfg: FieldConfig, train: bool,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """geo [R, S, G], directions [R, 3], camera_idx [R] → rgb [R, S, 3]."""
    if cfg.field_type == "vanilla":
        return vanilla_field_rgb(field, geo, directions, camera_idx, cfg,
                                 train, compute_dtype)
    lead = geo.shape[:-1]
    sh = sh_encoding(directions, cfg.sh_levels)
    parts = [sh[..., None, :].expand(*lead, sh.shape[-1]), geo]
    app = appearance_rows(field, camera_idx, cfg, train)
    if app is not None:
        parts.append(app[..., None, :].expand(*lead, app.shape[-1]))
    return mlp_apply(field.mlp_color, torch.cat(parts, dim=-1),
                     output_activation=torch.sigmoid,
                     compute_dtype=compute_dtype, impl=cfg.mlp_impl)


def field_all(field: Field, positions: torch.Tensor,
              directions: torch.Tensor, camera_idx: torch.Tensor,
              cfg: FieldConfig, train: bool,
              compute_dtype: torch.dtype = torch.bfloat16,
              pass_sem_grads: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(density, rgb, semantic logits) of one sample batch: one fused
    kernel for the vanilla field with ``mlp_impl="pallas-fused"``,
    otherwise the three functions above."""
    if cfg.field_type == "vanilla":
        return vanilla_field_all(field, positions, directions, camera_idx,
                                 cfg, train, compute_dtype=compute_dtype,
                                 pass_sem_grads=pass_sem_grads)
    density, geo = field_density(field, positions, cfg,
                                 compute_dtype=compute_dtype)
    rgb = field_rgb(field, geo, directions, camera_idx, cfg, train,
                    compute_dtype)
    sem = field_semantics(field, geo, cfg, compute_dtype, pass_sem_grads)
    return density, rgb, sem
