"""Analytic matmul-FLOP accounting for the train step (counterpart of
``cropnerf_tpu/utils/flops.py``).

Counts the model's matmul FLOPs per optimizer step from the config alone —
2·d_in·d_out per weight matrix per sample, encode selector-matmuls included,
elementwise work (activations, sin/cos, render weights, losses) excluded —
so that a measured step time gives TFLOP/s and MFU against a peak the
caller names (for one H100: its data sheet's dense bf16 rate, 989 TFLOP/s
at 700 W).  The counting functions hold the JAX file's code, so both
packages count the same FLOPs for every preset.

Conventions (the standard MFU bookkeeping, e.g. PaLM appendix B):
  * backward = 2x forward for every matmul that receives gradients
    (dgrad + wgrad); optimizer/update FLOPs ignored.
  * *model* FLOPs, not *executed* FLOPs: rematerialised recomputes (the
    fused PE-field kernels' recompute backward, ``ModelConfig.remat``) are
    NOT counted — MFU measured this way understates hardware utilisation
    on remat paths, which is the honest direction.
  * with ``proposal_no_grad_schedule`` the proposal backward only runs
    every ``proposal_update_every`` steps; its backward FLOPs are
    amortised accordingly.
  * hash-grid table gathers are memory ops, not FLOPs; reported separately
    as ``table_rows_per_step``.

No rate measured on or for another chip is kept here: ``mfu`` takes the
peak, and ``speed_of_light`` the per-shape ceilings, as arguments.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

from ..models.config import FieldConfig, ProposalFieldConfig, TrainConfig

_POS_FREQS = 10   # models/vanilla.py POS_FREQS
_DIR_FREQS = 4    # models/vanilla.py DIR_FREQS


def _mlp_dims(in_dim: int, hidden: int, out: int, n_layers: int) -> List[int]:
    """Mirror of ops/mlp.py ``mlp_init`` layer layout."""
    return [in_dim] + [hidden] * (n_layers - 1) + [out]


def _mlp_flops(dims: List[int]) -> int:
    """Forward matmul FLOPs per sample: 2·d_in·d_out per weight matrix."""
    return sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def field_flops_per_sample(cfg: FieldConfig) -> int:
    """Forward matmul FLOPs per field sample (density+rgb+semantics)."""
    if cfg.field_type == "vanilla":
        pos_dim = 3 * (2 * _POS_FREQS + 1)
        dir_dim = 3 * (2 * _DIR_FREQS + 1)
        hidden = max(cfg.hidden_dim, 64)
        f = 2 * 3 * pos_dim                       # PE selector matmul
        f += _mlp_flops(_mlp_dims(pos_dim, hidden, hidden, 4))      # base
        f += _mlp_flops(_mlp_dims(hidden + pos_dim, hidden,
                                  1 + cfg.geo_feat_dim, 4))         # top
        f += _mlp_flops(_mlp_dims(
            cfg.geo_feat_dim + dir_dim + cfg.appearance_embedding_dim,
            cfg.hidden_dim_color, 3, 2))                            # color
        f += _mlp_flops(_mlp_dims(cfg.geo_feat_dim,
                                  cfg.hidden_dim_semantics,
                                  cfg.num_semantic_classes,
                                  cfg.num_layers_semantic))         # semantic
        return f
    # hash field (models/field.py field_init)
    grid_dim = cfg.grid.num_levels * cfg.grid.features_per_level
    color_in = (cfg.sh_levels ** 2 + cfg.geo_feat_dim
                + cfg.appearance_embedding_dim)
    f = _mlp_flops(_mlp_dims(grid_dim, cfg.hidden_dim,
                             1 + cfg.geo_feat_dim, cfg.num_layers))
    f += _mlp_flops(_mlp_dims(cfg.geo_feat_dim, cfg.hidden_dim_semantics,
                              cfg.hidden_dim_semantics,
                              cfg.num_layers_semantic))
    f += 2 * cfg.hidden_dim_semantics * cfg.num_semantic_classes  # sem head
    f += _mlp_flops(_mlp_dims(color_in, cfg.hidden_dim_color, 3,
                              cfg.num_layers_color))
    return f


def prop_flops_per_sample(cfg: ProposalFieldConfig) -> int:
    """Forward matmul FLOPs per proposal-net sample."""
    n_layers = 1 if cfg.use_linear else cfg.num_layers
    if cfg.field_type == "pe":
        pe_dim = 3 * (2 * cfg.pe_freqs + 1)
        return (2 * 3 * pe_dim
                + _mlp_flops(_mlp_dims(pe_dim, cfg.hidden_dim, 1,
                                       max(n_layers, 2))))
    grid_dim = cfg.grid.num_levels * cfg.grid.features_per_level
    return _mlp_flops(_mlp_dims(grid_dim, cfg.hidden_dim, 1, n_layers))


def train_step_flops(cfg: TrainConfig) -> Dict[str, float]:
    """Per-step matmul-FLOP breakdown for one optimizer step.

    Returns forward FLOPs per component, the fwd+bwd total
    (``model_flops_per_step``) and hash-table gather rows.
    """
    m = cfg.model
    R = cfg.train_num_rays_per_batch
    field_fwd = R * m.num_nerf_samples_per_ray * field_flops_per_sample(
        m.field)
    prop_fwd = sum(
        R * n * prop_flops_per_sample(p)
        for p, n in zip(m.proposal_fields, m.num_proposal_samples_per_ray))
    # backward multiplier: dgrad + wgrad = 2x fwd.  Proposal backward is
    # amortised when the no-grad schedule skips it between update steps
    # (models/model.py prop_update).
    prop_bwd_mult = (2.0 / m.proposal_update_every
                     if m.proposal_no_grad_schedule else 2.0)
    total = field_fwd * 3.0 + prop_fwd * (1.0 + prop_bwd_mult)
    return {
        "field_fwd_flops": float(field_fwd),
        "prop_fwd_flops": float(prop_fwd),
        "fwd_flops": float(field_fwd + prop_fwd),
        "model_flops_per_step": float(total),
        "table_rows_per_step": float(_table_rows_per_step(cfg)),
    }


def _table_rows_per_step(cfg: TrainConfig) -> int:
    m = cfg.model
    R = cfg.train_num_rays_per_batch
    rows = 0
    if m.field.field_type == "hash":
        rows += (R * m.num_nerf_samples_per_ray
                 * m.field.grid.num_levels * 8)
    for p, n in zip(m.proposal_fields, m.num_proposal_samples_per_ray):
        if p.field_type == "hash":
            rows += R * n * p.grid.num_levels * 8
    return rows


def mfu(model_flops_per_step: float, step_seconds: float,
        peak_tflops: float) -> Dict[str, float]:
    """TFLOP/s of a measured step time, and its share of ``peak_tflops``
    (the card's peak for the matmuls' type, named by the caller)."""
    if not peak_tflops or peak_tflops <= 0:
        raise ValueError(f"mfu needs the card's peak TFLOP/s, got "
                         f"{peak_tflops!r}")
    tflops_per_s = model_flops_per_step / step_seconds / 1e12
    return {"tflops_per_s": tflops_per_s,
            "mfu": tflops_per_s / peak_tflops}


def _component_ceiling_tflops(hidden_dim: int,
                              ceilings: Mapping[str, float]) -> float:
    """The ceiling for a component whose matmuls are ``hidden_dim`` wide,
    from ``ceilings`` (TFLOP/s by shape: ``trunk256``, ``prop128``,
    ``prop64`` and the square fallback ``square4096``); widths without a
    ceiling of their own take the square one."""
    if hidden_dim >= 256:
        return ceilings["trunk256"]
    if hidden_dim == 128:
        return ceilings["prop128"]
    if hidden_dim == 64:
        return ceilings["prop64"]
    return ceilings["square4096"]


def speed_of_light(cfg: TrainConfig,
                   ceilings: Mapping[str, float]) -> Dict[str, float]:
    """Per-shape roofline speed-of-light (SOL) step time: each
    component's fwd+bwd matmul FLOPs over the ceiling measured on the
    card for its own matmul width (``ceilings``, TFLOP/s by shape, as
    :func:`_component_ceiling_tflops` reads them).  Elementwise and
    sampling work is excluded from the numerator, so ``measured_ms /
    sol_ms`` charges that time as inefficiency."""
    fl = train_step_flops(cfg)
    field = 3.0 * fl["field_fwd_flops"]
    prop = fl["model_flops_per_step"] - field
    field_ceiling = _component_ceiling_tflops(cfg.model.field.hidden_dim,
                                              ceilings)
    prop_dims = {p.hidden_dim for p in cfg.model.proposal_fields}
    prop_ceiling = min((_component_ceiling_tflops(d, ceilings)
                        for d in prop_dims),
                       default=ceilings["square4096"])
    sol_s = field / (field_ceiling * 1e12) + prop / (prop_ceiling * 1e12)
    return {"sol_ms": sol_s * 1e3, "field_ceiling_tflops": field_ceiling,
            "prop_ceiling_tflops": prop_ceiling}
