"""Per-group optimizer with exponential-decay learning rates (counterpart
of ``cropnerf_tpu/train/optim.py``).

The reference's three parameter groups, ``fields``, ``proposal_networks``
and ``camera_opt``, each with its own optimizer kind (``torch.optim.Adam``
or ``torch.optim.RAdam``), eps, weight decay and schedule.  Weight decay is
coupled L2 (added to the gradient before the update), which the JAX package
reproduces by chaining ``optax.add_decayed_weights`` before the transform.
As in optax, the update of step t (counted from 0) uses the schedule's
value at t.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

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


KINDS = {"adam": torch.optim.Adam, "radam": torch.optim.RAdam}


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


class GroupOptimizer:
    """The groups' optimizers, one torch optimizer per kind in use (the
    ``cropnerf-mxu-huge`` preset trains ``fields`` with Adam and
    ``camera_opt`` with RAdam), stepped together."""

    def __init__(self, optimizers: List[torch.optim.Optimizer]):
        self.optimizers = optimizers

    @property
    def param_groups(self) -> List[Dict]:
        return [g for opt in self.optimizers for g in opt.param_groups]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        for opt in self.optimizers:
            opt.step()

    def state_dict(self) -> List[Dict]:
        """Each optimizer's ``state_dict``, in order."""
        return [opt.state_dict() for opt in self.optimizers]

    def load_state_dict(self, states: List[Dict]) -> None:
        """Load :meth:`state_dict`'s list.  Torch matches the moments to the
        parameters by their order in each group, which ``make_optimizer``
        keeps as ``named_parameters`` gives it.  An unfused torch optimizer
        keeps its step counts on the host; a checkpoint loaded with
        ``map_location`` on the card brings them there, so they go back
        to the host (on the card every update would wait to read them)."""
        if len(states) != len(self.optimizers):
            raise ValueError(f"{len(states)} optimizer states for "
                             f"{len(self.optimizers)} optimizers")
        for opt, st in zip(self.optimizers, states):
            opt.load_state_dict(st)
            for s in opt.state.values():
                if torch.is_tensor(s.get("step")):
                    s["step"] = s["step"].cpu()


def make_optimizer(params: nn.Module, cfg: TrainConfig) -> GroupOptimizer:
    """The three groups of ``params`` (a CropNeRFParams) under their
    optimizer kinds; call :func:`apply_updates` to take a step."""
    kinds = {"fields": cfg.optimizer, "proposal_networks": cfg.optimizer,
             "camera_opt": cfg.camera_opt_optimizer}
    for kind in kinds.values():
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
    members = {g: [] for g in GROUPS}
    for name, p in params.named_parameters():
        members[optimizer_group_of(name.split(".")[0])].append(p)
    settings = {
        "fields": (cfg.adam_eps, 0.0),
        "proposal_networks": (cfg.adam_eps, 0.0),
        "camera_opt": (cfg.camera_opt_eps, cfg.camera_opt_weight_decay),
    }
    schedules = group_schedules(cfg)
    by_kind: Dict[str, List[Dict]] = {}
    for g in GROUPS:
        if members[g]:
            by_kind.setdefault(kinds[g], []).append(dict(
                params=members[g], name=g, lr=schedules[g](0),
                eps=settings[g][0], weight_decay=settings[g][1]))
    return GroupOptimizer([KINDS[kind](groups, betas=(0.9, 0.999))
                           for kind, groups in by_kind.items()])


def apply_updates(optimizer: GroupOptimizer, cfg: TrainConfig,
                  step: int) -> None:
    """One optimizer update at schedule step ``step`` (the count of
    updates before it), in place on the parameters."""
    schedules = group_schedules(cfg)
    for group in optimizer.param_groups:
        group["lr"] = schedules[group["name"]](step)
    optimizer.step()
