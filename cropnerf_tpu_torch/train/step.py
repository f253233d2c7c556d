"""The training step, the eval-batch metrics and the chunked full-image
renderer (counterpart of ``cropnerf_tpu/train/step.py``).

One step: sample pixels from the resident bank, generate rays, run
``forward(train=True)``, sum the losses, backpropagate (on the card
through the ``fused_pe_nerf`` backward kernel of the vanilla field, or the
``hash_encode`` backward kernel of each hash grid) and take one optimizer
update.  PyTorch runs eagerly, so where the JAX package jits one program
per step the port issues the same work operation by operation; the step
updates the parameters and the optimizer state in place (JAX's buffer
donation has no counterpart).  The multi-device step comes with the
multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.cameras import Cameras, generate_rays, near_far_collider
from ..core.rays import RayBundle
from ..data.databank import PixelBank, decode_pixel_index
from ..models.config import TrainConfig
from ..models.model import CropNeRFParams, anneal_factor, forward
from ..ops import losses as loss_ops
from ..ops import metrics as metric_ops
from .optim import apply_updates
from .state import TrainState


def _prop_update_bool(step, cfg: TrainConfig) -> torch.Tensor:
    """Proposal-net update schedule: the period ramps from 1 to
    ``proposal_update_every`` over ``proposal_warmup`` steps, rounded half
    to even (``torch.round``, as ``jnp.round``); True on update steps."""
    m = cfg.model
    step = torch.as_tensor(step, dtype=torch.int32)
    period = (step.float() / m.proposal_warmup * m.proposal_update_every
              ).clamp(1.0, m.proposal_update_every)
    return step % torch.round(period).to(torch.int32) == 0


def compute_losses(params: CropNeRFParams, outputs: Dict, rgb_gt: torch.Tensor,
                   mask_gt: torch.Tensor, cfg: TrainConfig,
                   prop_flag: float = 1.0) -> Tuple[torch.Tensor, Dict]:
    """The loss and its terms: RGB MSE, semantic BCE, interlevel (times
    ``prop_flag``), distortion and the camera-opt regulariser."""
    m = cfg.model
    rgb_loss = loss_ops.mse_loss(outputs["rgb"], rgb_gt)
    sem_loss = loss_ops.bce_with_logits(outputs["semantics"][..., 0], mask_gt)
    inter = loss_ops.interlevel_loss(outputs["weights_list"],
                                     outputs["sdist_list"])
    dist = loss_ops.distortion_loss(outputs["weights_list"][-1],
                                    outputs["sdist_list"][-1])
    cam_reg = loss_ops.camera_opt_regularizer(
        params.camera_opt, m.camera_opt.trans_l2_penalty,
        m.camera_opt.rot_l2_penalty)
    if m.camera_opt.mode == "off":
        cam_reg = 0.0 * cam_reg
    loss = (rgb_loss
            + m.semantic_loss_weight * sem_loss
            + m.interlevel_loss_mult * inter * prop_flag
            + m.distortion_loss_mult * dist
            + cam_reg)
    return loss, {
        "loss": loss, "rgb_loss": rgb_loss, "semantics_loss": sem_loss,
        "interlevel_loss": inter, "distortion_loss": dist,
        "camera_opt_regularizer": cam_reg,
    }


def _bank_rays(bank: PixelBank, idx: torch.Tensor, cfg: TrainConfig):
    """Ground truth and the collided ray bundle of pixels ``idx``."""
    m = cfg.model
    cam, px, py = decode_pixel_index(idx, bank.height, bank.width)
    rgb_gt = bank.rgb[idx].float() / 255.0
    mask_gt = bank.mask[idx].float()
    origins, dirs = generate_rays(bank.cameras, cam, px, py)
    n = idx.shape[0]
    rb = RayBundle(origins=origins, directions=dirs,
                   nears=torch.zeros((n,), device=origins.device),
                   fars=torch.ones((n,), device=origins.device),
                   camera_idx=cam)
    return rgb_gt, mask_gt, near_far_collider(rb, m.near_plane, m.far_plane)


def train_loss(params: CropNeRFParams, bank: PixelBank, idx: torch.Tensor,
               step: int, cfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               compute_dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, Dict]:
    """(loss, metrics) of one training batch, the pixels ``idx`` [R] of the
    bank, with the autograd graph recorded (the JAX step's ``loss_fn``).
    ``generator`` jitters the samplers; None: no jitter."""
    m = cfg.model
    rgb_gt, mask_gt, rb = _bank_rays(bank, idx, cfg)
    upd = _prop_update_bool(step, cfg)
    outputs = forward(params, rb, m, train=True,
                      anneal=anneal_factor(step, m),
                      compute_dtype=compute_dtype, generator=generator,
                      prop_update=(bool(upd) if m.proposal_no_grad_schedule
                                   else None))
    loss, aux = compute_losses(params, outputs, rgb_gt, mask_gt, cfg,
                               float(upd))
    aux["psnr"] = metric_ops.psnr(outputs["rgb"], rgb_gt)
    return loss, aux


def _sample_pixels(bank: PixelBank, n: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    device = generator.device if generator is not None else bank.rgb.device
    idx = torch.randint(0, bank.num_pixels, (n,), generator=generator,
                        device=device)
    return idx.to(bank.rgb.device)


def make_train_step(cfg: TrainConfig, num_inner: int = 1,
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``train_step(state, bank, generator) -> (state, metrics)``.

    Each step draws ``train_num_rays_per_batch`` pixels and the samplers'
    jitter from ``generator`` (None: torch's default generator for the
    pixels and no jitter), backpropagates and updates ``state`` in place.
    ``num_inner`` steps run per call; the metrics are the last step's,
    0-dim tensors on the bank's device (nothing waits for the card)."""
    R = cfg.train_num_rays_per_batch

    def train_step(state: TrainState, bank: PixelBank,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        for _ in range(num_inner):
            idx = _sample_pixels(bank, R, generator)
            state.optimizer.zero_grad(set_to_none=True)
            loss, aux = train_loss(state.params, bank, idx, state.step, cfg,
                                   generator, compute_dtype)
            loss.backward()
            apply_updates(state.optimizer, cfg, state.step)
            state.step += 1
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step


def make_eval_batch_fn(cfg: TrainConfig,
                       compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``eval_batch(params, bank, generator) -> metrics``: the losses and
    PSNR of ``eval_num_rays_per_batch`` random pixels of an eval bank,
    forward in eval mode, no graph."""
    m = cfg.model
    R = cfg.eval_num_rays_per_batch

    @torch.no_grad()
    def eval_batch(params: CropNeRFParams, bank: PixelBank,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        idx = _sample_pixels(bank, R, generator)
        rgb_gt, mask_gt, rb = _bank_rays(bank, idx, cfg)
        outputs = forward(params, rb, m, train=False,
                          compute_dtype=compute_dtype)
        _, aux = compute_losses(params, outputs, rgb_gt, mask_gt, cfg)
        aux["psnr"] = metric_ops.psnr(outputs["rgb"], rgb_gt)
        return aux

    return eval_batch

RENDER_KEYS = ("rgb", "accumulation", "depth", "semantics",
               "semantics_colormap")


def make_render_fn(cfg: TrainConfig, background: Optional[str] = None,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   density_hook: Optional[Callable] = None) -> Callable:
    """``render(params, cameras, cam_index, height, width, hook_arg=0.0)``
    → image-shaped outputs [H, W, C].  The pixels are padded to a whole
    number of ``eval_num_rays_per_chunk`` chunks, so every chunk has one
    shape, and rendered one chunk at a time.  ``density_hook`` is an
    optional (positions, density, hook_arg) -> density post-filter, and
    ``hook_arg`` a float given per call (the viewer's uncertainty-filter
    slider)."""
    m = cfg.model
    chunk = cfg.eval_num_rays_per_chunk

    @torch.no_grad()
    def render(params: CropNeRFParams, cameras: Cameras, cam_index: int,
               height: int, width: int,
               hook_arg: float = 0.0) -> Dict[str, torch.Tensor]:
        hook = (None if density_hook is None
                else lambda p, d: density_hook(p, d, hook_arg))
        device = cameras.c2w.device
        ys, xs = torch.meshgrid(torch.arange(height, device=device),
                                torch.arange(width, device=device),
                                indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
        n = xs.shape[0]
        n_pad = (-n) % chunk
        zeros = torch.zeros((n_pad,), dtype=xs.dtype, device=device)
        xs, ys = torch.cat([xs, zeros]), torch.cat([ys, zeros])
        cam = torch.full_like(xs, cam_index)

        pieces = {k: [] for k in RENDER_KEYS}
        for start in range(0, xs.shape[0], chunk):
            cx = cam[start:start + chunk]
            px, py = xs[start:start + chunk], ys[start:start + chunk]
            origins, dirs = generate_rays(cameras, cx, px, py)
            ones = torch.ones_like(px, dtype=torch.float32)
            rb = RayBundle(origins=origins, directions=dirs,
                           nears=torch.zeros_like(ones), fars=ones,
                           camera_idx=cx)
            rb = near_far_collider(rb, m.near_plane, m.far_plane)
            out = forward(params, rb, m, train=False, background=background,
                          compute_dtype=compute_dtype, density_hook=hook)
            for k in RENDER_KEYS:
                pieces[k].append(out[k])
        return {k: torch.cat(v)[:n].reshape(height, width, -1)
                for k, v in pieces.items()}

    return render
