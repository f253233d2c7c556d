"""Per-group optimizer with exponential-decay learning rates (counterpart
of ``cropnerf_tpu/train/optim.py``).

One ``torch.optim.Adam`` over the model with the reference's three
parameter groups, ``fields``, ``proposal_networks`` and ``camera_opt``,
each with its own eps, weight decay and schedule.  As in optax, the update
of step t (counted from 0) uses the schedule's value at t.  RAdam, which
only the hash-grid presets use, comes with the hash-grid slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models.config import TrainConfig

GROUPS = ("fields", "proposal_networks", "camera_opt")


def exp_decay_schedule(lr_init: float, lr_final: Optional[float],
                       max_steps: int) -> Callable[[int], float]:
    """nerfstudio ExponentialDecayScheduler: lr(t) = init·(final/init)^(t/T),
    held at lr_final past T; ``lr_final=None`` is a constant lr.  Evaluated
    in float32, as the JAX schedule is."""
    if lr_final is None:
        return lambda step: lr_init
    f32 = np.float32

    def schedule(step: int) -> float:
        t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
        return float(f32(lr_init) * f32(lr_final / lr_init) ** t)
    return schedule


def optimizer_group_of(param_key: str) -> str:
    """Top-level params key → optimizer group."""
    if param_key == "camera_opt":
        return "camera_opt"
    if param_key.startswith("proposal_"):
        return "proposal_networks"
    return "fields"


def _check_kind(kind: str) -> None:
    if kind == "radam":
        raise NotImplementedError(
            "optimizer 'radam' (the hash-grid presets) comes with the "
            "hash-grid slice (slice 4)")
    if kind != "adam":
        raise ValueError(f"unknown optimizer {kind!r}")


def group_schedules(cfg: TrainConfig):
    """Group name → lr schedule."""
    return {
        "fields": exp_decay_schedule(cfg.learning_rate, cfg.lr_final,
                                     cfg.lr_decay_max_steps),
        "proposal_networks": exp_decay_schedule(
            cfg.prop_learning_rate, cfg.prop_lr_final,
            cfg.prop_lr_decay_max_steps),
        "camera_opt": exp_decay_schedule(
            cfg.camera_opt_lr, cfg.camera_opt_lr_final,
            cfg.camera_opt_decay_steps),
    }


def make_optimizer(params: nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over ``params`` (a CropNeRFParams) in three groups; call
    :func:`apply_updates` to take a step."""
    _check_kind(cfg.optimizer)
    _check_kind(cfg.camera_opt_optimizer)
    members = {g: [] for g in GROUPS}
    for name, p in params.named_parameters():
        members[optimizer_group_of(name.split(".")[0])].append(p)
    settings = {
        "fields": (cfg.adam_eps, 0.0),
        "proposal_networks": (cfg.adam_eps, 0.0),
        "camera_opt": (cfg.camera_opt_eps, cfg.camera_opt_weight_decay),
    }
    schedules = group_schedules(cfg)
    groups = [dict(params=members[g], name=g, lr=schedules[g](0),
                   eps=settings[g][0], weight_decay=settings[g][1])
              for g in GROUPS if members[g]]
    return torch.optim.Adam(groups, betas=(0.9, 0.999))


def apply_updates(optimizer: torch.optim.Adam, cfg: TrainConfig,
                  step: int) -> None:
    """One optimizer update at schedule step ``step`` (the count of
    updates before it), in place on the parameters."""
    schedules = group_schedules(cfg)
    for group in optimizer.param_groups:
        group["lr"] = schedules[group["name"]](step)
    optimizer.step()
