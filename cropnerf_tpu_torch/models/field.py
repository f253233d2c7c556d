"""Field dispatch (counterpart of ``cropnerf_tpu/models/field.py``): the
vanilla field only; the hash-grid field comes with the hash-grid slice."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import FieldConfig
from .vanilla import (VanillaField, vanilla_field_all, vanilla_field_density,
                      vanilla_field_init, vanilla_field_rgb,
                      vanilla_field_semantics)

HASH_NOT_PORTED = ("the hash-grid field is not ported yet (hash-grid family "
                   "slice: ops/hashgrid.py and the hash_encode kernel)")


def _vanilla_only(cfg: FieldConfig) -> None:
    if cfg.field_type != "vanilla":
        raise NotImplementedError(HASH_NOT_PORTED)


def field_init(cfg: FieldConfig, num_images: int, generator: torch.Generator,
               device: torch.device | str = "cpu") -> VanillaField:
    _vanilla_only(cfg)
    return vanilla_field_init(cfg, num_images, generator, device)


def field_density(field: VanillaField, positions: torch.Tensor,
                  cfg: FieldConfig, aabb: Optional[torch.Tensor] = None,
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    _vanilla_only(cfg)
    return vanilla_field_density(field, positions, cfg, aabb, compute_dtype)


def field_semantics(field: VanillaField, geo: torch.Tensor, cfg: FieldConfig,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    _vanilla_only(cfg)
    return vanilla_field_semantics(field, geo, cfg, compute_dtype)


def field_rgb(field: VanillaField, geo: torch.Tensor,
              directions: torch.Tensor, camera_idx: torch.Tensor,
              cfg: FieldConfig, train: bool,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    _vanilla_only(cfg)
    return vanilla_field_rgb(field, geo, directions, camera_idx, cfg, train,
                             compute_dtype)


def field_all(field: VanillaField, positions: torch.Tensor,
              directions: torch.Tensor, camera_idx: torch.Tensor,
              cfg: FieldConfig, train: bool,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _vanilla_only(cfg)
    return vanilla_field_all(field, positions, directions, camera_idx, cfg,
                             train, compute_dtype=compute_dtype)
