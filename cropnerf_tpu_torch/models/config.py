"""Typed model/config tree with named presets.

The port's own copy of ``cropnerf_tpu/models/config.py``: the same frozen
dataclasses, defaults and ``PRESETS``, field for field (pinned by
``tests/test_torch_model.py``), so a run configuration written by either
package describes the same model.  Option values that only the JAX package
acts on (hash-grid ``impl``/``cell_pack``, the Pallas row tiles, remat) are
kept so the trees stay equal; the port ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    min_res: int = 16
    max_res: int = 2048
    impl: str = "xla"
    layout: str = "packed"
    cell_pack: bool = True


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Hash-grid field, or with ``field_type="vanilla"`` the
    positional-encoding MLP field."""
    field_type: str = "hash"            # "hash" | "vanilla"
    grid: HashGridConfig = HashGridConfig()
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_semantic: int = 2
    hidden_dim_semantics: int = 64
    num_semantic_classes: int = 1
    # "xla" (plain matmuls), "pallas" (the fused-MLP kernel) or
    # "pallas-fused" (vanilla field only: PE encode + trunk + heads in the
    # fused PE-field kernels; plain heads use the fused-MLP kernel)
    mlp_impl: str = "xla"
    fused_tile: int = 1024
    fused_tile_bwd: int = 768
    appearance_embedding_dim: int = 32
    use_average_appearance_embedding: bool = True
    sh_levels: int = 4
    use_contraction: bool = True


@dataclasses.dataclass(frozen=True)
class ProposalFieldConfig:
    """Proposal density net: hash grid + MLP, or with ``field_type="pe"`` a
    positional-encoding MLP."""
    field_type: str = "hash"            # "hash" | "pe"
    grid: HashGridConfig = HashGridConfig(num_levels=5, log2_hashmap_size=17,
                                          max_res=128)
    hidden_dim: int = 16
    num_layers: int = 2
    use_linear: bool = False
    pe_freqs: int = 5
    mlp_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class CameraOptConfig:
    mode: str = "SO3xR3"           # "off" | "SO3xR3"
    trans_l2_penalty: float = 1e-2
    rot_l2_penalty: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    field: FieldConfig = FieldConfig()
    proposal_fields: Tuple[ProposalFieldConfig, ...] = (
        ProposalFieldConfig(grid=HashGridConfig(num_levels=5, log2_hashmap_size=17, max_res=128)),
        ProposalFieldConfig(grid=HashGridConfig(num_levels=5, log2_hashmap_size=17, max_res=256)),
    )
    num_nerf_samples_per_ray: int = 48
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    use_single_jitter: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    proposal_no_grad_schedule: bool = True
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    semantic_loss_weight: float = 1.0
    pass_semantic_gradients: bool = False
    use_gradient_scaling: bool = False
    camera_opt: CameraOptConfig = CameraOptConfig()
    remat: bool = True
    remat_props: bool = False

    @property
    def num_proposal_iterations(self) -> int:
        return len(self.num_proposal_samples_per_ray)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    max_num_iterations: int = 40_000
    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 4096
    eval_num_rays_per_chunk: int = 1 << 15
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25_000
    steps_per_save: int = 2000
    optimizer: str = "adam"                 # "adam" | "radam"
    learning_rate: float = 1e-2             # "fields" group
    adam_eps: float = 1e-15
    lr_final: Optional[float] = 1e-4        # None → constant lr
    lr_decay_max_steps: int = 200_000
    prop_learning_rate: float = 1e-2        # "proposal_networks" group
    prop_lr_final: Optional[float] = 1e-4
    prop_lr_decay_max_steps: int = 200_000
    camera_opt_optimizer: str = "adam"
    camera_opt_lr: float = 1e-3
    camera_opt_eps: float = 1e-15
    camera_opt_weight_decay: float = 0.0
    camera_opt_lr_final: Optional[float] = 1e-4
    camera_opt_decay_steps: int = 5000
    seed: int = 42


def _big_model() -> ModelConfig:
    return ModelConfig(
        field=FieldConfig(
            grid=HashGridConfig(log2_hashmap_size=21, max_res=4096),
            hidden_dim=128, hidden_dim_color=128, hidden_dim_semantics=128,
            num_layers_semantic=3, appearance_embedding_dim=128,
            geo_feat_dim=30),
        proposal_fields=(
            ProposalFieldConfig(grid=HashGridConfig(num_levels=5, log2_hashmap_size=17, max_res=128)),
            ProposalFieldConfig(grid=HashGridConfig(num_levels=5, log2_hashmap_size=17, max_res=256)),
        ),
        num_nerf_samples_per_ray=128,
        num_proposal_samples_per_ray=(512, 256),
        proposal_weights_anneal_max_num_iters=5000,
    )


def _huge_model() -> ModelConfig:
    return ModelConfig(
        field=FieldConfig(
            grid=HashGridConfig(log2_hashmap_size=21, max_res=8192),
            hidden_dim=256, hidden_dim_color=256, hidden_dim_semantics=128,
            num_layers_semantic=3, geo_feat_dim=30),
        proposal_fields=(
            ProposalFieldConfig(grid=HashGridConfig(num_levels=5, log2_hashmap_size=17, max_res=512),
                                hidden_dim=16),
            ProposalFieldConfig(grid=HashGridConfig(num_levels=7, log2_hashmap_size=17, max_res=2048),
                                hidden_dim=16),
        ),
        num_nerf_samples_per_ray=64,
        num_proposal_samples_per_ray=(512, 512),
        proposal_weights_anneal_max_num_iters=5000,
    )


def model_config_from_dict(d: dict) -> ModelConfig:
    """Rebuild a ModelConfig from ``dataclasses.asdict`` output (the
    run_config.json round-trip)."""
    return ModelConfig(
        field=FieldConfig(**{**d["field"],
                             "grid": HashGridConfig(**d["field"]["grid"])}),
        proposal_fields=tuple(
            ProposalFieldConfig(**{**p, "grid": HashGridConfig(**p["grid"])})
            for p in d["proposal_fields"]),
        camera_opt=CameraOptConfig(**d["camera_opt"]),
        **{k: (tuple(v) if isinstance(v, list) else v)
           for k, v in d.items()
           if k not in ("field", "proposal_fields", "camera_opt")})


def train_config_from_dict(d: dict) -> "TrainConfig":
    """Rebuild a TrainConfig from ``dataclasses.asdict`` output."""
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        kwargs[k] = model_config_from_dict(v) if k == "model" else v
    return TrainConfig(**kwargs)


PRESETS = {
    "cropnerf": TrainConfig(model=ModelConfig(remat=False)),
    "cropnerf-big": TrainConfig(
        model=_big_model(), max_num_iterations=100_000,
        train_num_rays_per_batch=8192, eval_num_rays_per_batch=4096,
        optimizer="radam", lr_decay_max_steps=50_000, prop_lr_final=None),
    "cropnerf-huge": TrainConfig(
        model=_huge_model(), max_num_iterations=100_000,
        train_num_rays_per_batch=16384, eval_num_rays_per_batch=4096,
        optimizer="radam", lr_decay_max_steps=50_000, prop_lr_final=None,
        camera_opt_optimizer="radam", camera_opt_lr=6e-4,
        camera_opt_eps=1e-8, camera_opt_weight_decay=1e-3,
        camera_opt_lr_final=6e-5, camera_opt_decay_steps=50_000),
    "semantic-nerf": TrainConfig(
        model=ModelConfig(field=FieldConfig(field_type="vanilla"))),
    # The flagship: positional-encoding trunk and proposal nets, no hash
    # tables.  mlp_impl="pallas-fused" routes the field through the fused
    # PE-field kernels (ops/cuda/fused_pe_field.py in this package).
    "cropnerf-mxu": TrainConfig(
        model=ModelConfig(
            field=FieldConfig(field_type="vanilla", hidden_dim=256,
                              geo_feat_dim=15, hidden_dim_color=64,
                              hidden_dim_semantics=64,
                              mlp_impl="pallas-fused"),
            proposal_fields=(
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=5),
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=6),
            ),
            proposal_no_grad_schedule=False,
            remat=False,
        ),
        learning_rate=1e-3, lr_final=1e-5, lr_decay_max_steps=50_000,
        prop_learning_rate=1e-3, prop_lr_final=1e-5,
        prop_lr_decay_max_steps=50_000, adam_eps=1e-8),
    "cropnerf-mxu-q": TrainConfig(
        model=ModelConfig(
            field=FieldConfig(field_type="vanilla", hidden_dim=256,
                              geo_feat_dim=15, hidden_dim_color=64,
                              hidden_dim_semantics=64,
                              mlp_impl="pallas-fused"),
            proposal_fields=(
                ProposalFieldConfig(field_type="pe", hidden_dim=128,
                                    num_layers=3, pe_freqs=5),
                ProposalFieldConfig(field_type="pe", hidden_dim=128,
                                    num_layers=3, pe_freqs=6),
            ),
            proposal_no_grad_schedule=False,
            remat=False,
        ),
        learning_rate=1e-3, lr_final=1e-5, lr_decay_max_steps=50_000,
        prop_learning_rate=1e-3, prop_lr_final=1e-5,
        prop_lr_decay_max_steps=50_000, adam_eps=1e-8),
    "cropnerf-mxu-big": TrainConfig(
        model=ModelConfig(
            field=FieldConfig(field_type="vanilla", hidden_dim=256,
                              geo_feat_dim=30, hidden_dim_color=128,
                              hidden_dim_semantics=128,
                              num_layers_semantic=3,
                              appearance_embedding_dim=128,
                              mlp_impl="pallas-fused", fused_tile_bwd=512),
            proposal_fields=(
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=6),
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=7),
            ),
            num_nerf_samples_per_ray=128,
            num_proposal_samples_per_ray=(512, 256),
            proposal_weights_anneal_max_num_iters=5000,
            proposal_no_grad_schedule=False, remat=False),
        max_num_iterations=100_000,
        train_num_rays_per_batch=8192, eval_num_rays_per_batch=4096,
        learning_rate=1e-3, lr_final=1e-5, lr_decay_max_steps=100_000,
        prop_learning_rate=1e-3, prop_lr_final=1e-5,
        prop_lr_decay_max_steps=100_000, adam_eps=1e-8),
    "cropnerf-mxu-huge": TrainConfig(
        model=ModelConfig(
            field=FieldConfig(field_type="vanilla", hidden_dim=256,
                              geo_feat_dim=30, hidden_dim_color=256,
                              hidden_dim_semantics=128,
                              num_layers_semantic=3,
                              mlp_impl="pallas-fused", fused_tile_bwd=512),
            proposal_fields=(
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=7),
                ProposalFieldConfig(field_type="pe", hidden_dim=64,
                                    num_layers=3, pe_freqs=8),
            ),
            num_nerf_samples_per_ray=64,
            num_proposal_samples_per_ray=(512, 512),
            proposal_weights_anneal_max_num_iters=5000,
            proposal_no_grad_schedule=False, remat=False),
        max_num_iterations=100_000,
        train_num_rays_per_batch=16384, eval_num_rays_per_batch=4096,
        learning_rate=1e-3, lr_final=1e-5, lr_decay_max_steps=100_000,
        prop_learning_rate=1e-3, prop_lr_final=1e-5,
        prop_lr_decay_max_steps=100_000, adam_eps=1e-8,
        camera_opt_optimizer="radam", camera_opt_lr=6e-4,
        camera_opt_eps=1e-8, camera_opt_weight_decay=1e-3,
        camera_opt_lr_final=6e-5, camera_opt_decay_steps=50_000),
    # tiny CPU-runnable preset for tests
    "cropnerf-tiny": TrainConfig(
        model=ModelConfig(
            field=FieldConfig(grid=HashGridConfig(num_levels=4, log2_hashmap_size=12, max_res=64),
                              hidden_dim=16, hidden_dim_color=16,
                              hidden_dim_semantics=16, geo_feat_dim=7,
                              appearance_embedding_dim=4),
            proposal_fields=(
                ProposalFieldConfig(grid=HashGridConfig(num_levels=3, log2_hashmap_size=10, max_res=32),
                                    hidden_dim=8),
            ),
            num_nerf_samples_per_ray=16,
            num_proposal_samples_per_ray=(32,),
            proposal_weights_anneal_max_num_iters=50,
            remat=False,
        ),
        max_num_iterations=200, train_num_rays_per_batch=256,
        eval_num_rays_per_batch=256, eval_num_rays_per_chunk=1024),
}
