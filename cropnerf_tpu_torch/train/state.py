"""Train state: parameters, optimizer and step counter (counterpart of
``cropnerf_tpu/train/state.py``)."""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import TrainConfig
from ..models.model import CropNeRFParams, model_init
from .optim import GroupOptimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The training step updates ``params`` and the optimizer's moments in
    place and advances ``step``, the count of updates taken."""

    params: CropNeRFParams
    optimizer: GroupOptimizer
    step: int = 0


def create_train_state(cfg: TrainConfig, num_images: int,
                       generator: torch.Generator,
                       device: torch.device | str = "cuda") -> TrainState:
    """Random parameters from ``generator`` on ``device``, a fresh
    optimizer and step 0."""
    params = model_init(cfg.model, num_images, generator, device)
    return TrainState(params=params, optimizer=make_optimizer(params, cfg))
