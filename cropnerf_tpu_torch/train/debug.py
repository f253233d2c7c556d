"""Independent oracle for the sharded training path (counterpart of
``cropnerf_tpu/train/debug.py``).

``replay_sharded_step`` recomputes, in ONE process against the GLOBAL
pixel bank, what :func:`cropnerf_tpu_torch.train.step.make_sharded_train_step`
computes across the ranks: the same per-rank generator derivation
(``rank_generator`` of the seed, the step and the rank), the same pixel
indices, the same loss; then it averages the per-rank gradients.  Holding
its result against the real step checks the three things the sharded path
can get silently wrong (the reference's DDP gradient-equivalence
contract, fruit_pipeline.py:119-121):

  * the shard layout (rank r owns global pixel rows [r·P/N, (r+1)·P/N),
    that is images [r·I/N, (r+1)·I/N));
  * the global camera-id arithmetic (``cam = cam_l + r·images_per_rank``);
  * the gradient and metric all-reduce.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.databank import PixelBank
from ..models.config import TrainConfig
from .state import TrainState
from .step import local_pixel_draw, named_grads, rank_generator, train_loss

METRICS = ("loss", "rgb_loss", "semantics_loss", "psnr")


def replay_sharded_step(state: TrainState, bank_global: PixelBank,
                        generator: Optional[torch.Generator],
                        cfg: TrainConfig, ndev: int,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """The averaged gradients (under ``grads``) and metrics of one
    sharded step over ``ndev`` ranks, replayed in this process on
    ``bank_global``, the UNSHARDED padded bank.  Unlike the JAX oracle it
    takes no optimizer update: ``state`` is left as it was (its gradients
    cleared), for the real step to run from.  ``generator`` None: no
    jitter, as in the step."""
    R = cfg.train_num_rays_per_batch
    assert R % ndev == 0
    R_local = R // ndev
    hw = bank_global.height * bank_global.width
    local_pixels = bank_global.num_pixels // ndev
    assert local_pixels % hw == 0, "the global bank does not split by image"
    device = bank_global.rgb.device
    state.optimizer.zero_grad(set_to_none=True)
    aux_sum: Dict[str, torch.Tensor] = {}
    for d in range(ndev):
        gen = (rank_generator(generator, state.step, d)
               if generator is not None else None)
        idx_local = local_pixel_draw(local_pixels, R_local, gen, device)
        loss, aux = train_loss(state.params, bank_global,
                               d * local_pixels + idx_local, state.step,
                               cfg, gen, compute_dtype)
        # gradients accumulate over the ranks in rank order, as the
        # all-reduce sums them
        loss.backward()
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
    grads = {k: g / ndev for k, g in named_grads(state.params).items()}
    out = {k: v / ndev for k, v in aux_sum.items()}
    out["grads"] = grads
    state.optimizer.zero_grad(set_to_none=True)
    return out


def leaf_group(name: str) -> str:
    """The group a gradient leaf is reported under: ``camera_opt``,
    ``proposal_i`` or the field's first two name parts."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "field" else parts[0]


def assert_grads_match(got: Dict[str, torch.Tensor],
                       ref: Dict[str, torch.Tensor], atol: float = 3e-5,
                       rtol: float = 1e-2,
                       atol_camera_opt: Optional[float] = None
                       ) -> Dict[str, float]:
    """Hold the sharded step's metrics and averaged gradients ``got``
    against the replay's ``ref`` (both as the steps return them: metrics
    beside ``grads``).  Returns the largest gradient deviation per leaf
    group.

    ``atol_camera_opt``: the camera_opt leaf's own tolerance.  Its
    gradient is a sum of per-ray pose terms that cancel, so summation
    order alone moves it more than any field leaf (the JAX package
    measures ~3.5e-4 on its flagship in float32); None uses ``atol``."""
    worst: Dict[str, float] = {}
    for name, a in got["grads"].items():
        b = ref["grads"][name]
        tol = (atol_camera_opt if atol_camera_opt is not None
               and name.startswith("camera_opt") else atol)
        a64 = a.detach().double().cpu().numpy()
        b64 = b.detach().double().cpu().numpy()
        group = leaf_group(name)
        worst[group] = max(worst.get(group, 0.0),
                           float(np.abs(a64 - b64).max(initial=0.0)))
        np.testing.assert_allclose(a64, b64, atol=tol, rtol=rtol,
                                   err_msg=name)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    return worst


def assert_sharded_step_matches_replay(state: TrainState,
                                       bank_sharded: PixelBank,
                                       bank_global: PixelBank,
                                       generator: torch.Generator,
                                       cfg: TrainConfig, mesh,
                                       atol: float = 3e-5,
                                       rtol: float = 1e-2,
                                       atol_camera_opt: Optional[float] = None,
                                       compute_dtype: torch.dtype =
                                       torch.bfloat16) -> float:
    """Run the replay, then the real sharded step (every rank calls this
    together; it updates ``state``), and assert their averaged GRADIENTS
    and metrics agree (gradients are the DDP contract: parameters after
    Adam at eps 1e-15 are not comparable, since a reassociation sign flip
    on a near-zero gradient moves a parameter by ±2·lr).  Returns the
    largest gradient deviation."""
    from .step import make_sharded_train_step
    ref = replay_sharded_step(state, bank_global, generator, cfg, mesh.size,
                              compute_dtype=compute_dtype)
    step = make_sharded_train_step(cfg, mesh, return_grads=True,
                                   compute_dtype=compute_dtype)
    _, got = step(state, bank_sharded, generator)
    worst = assert_grads_match(got, ref, atol, rtol, atol_camera_opt)
    return max(worst.values())
