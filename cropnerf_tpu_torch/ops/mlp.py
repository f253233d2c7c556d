"""Fully connected MLPs (counterpart of ``cropnerf_tpu/ops/mlp.py``).

Weights keep the JAX layout, ``w[i]`` of shape [in, out] and ``b[i]`` of
shape [out], so converting a JAX params tree is a plain tree walk.  Weights
are stored in float32; the compute dtype (bf16 by default, or float32) is
what each matmul's operands are rounded to, with float32 accumulation.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn


class MLP(nn.Module):
    """Weights ``w`` ([in, out] each) and biases ``b`` of a dense stack."""

    def __init__(self, ws: List[torch.Tensor], bs: List[torch.Tensor]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w) for w in ws])
        self.b = nn.ParameterList([nn.Parameter(b) for b in bs])

    def __len__(self) -> int:
        return len(self.w)


def mm_f32acc(a: torch.Tensor, w: torch.Tensor,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """a @ w with both operands rounded to ``compute_dtype`` and the sum
    taken in float32 (JAX ``jnp.dot(..., preferred_element_type=f32)``)."""
    return a.to(compute_dtype).float() @ w.to(compute_dtype).float()


def mlp_init(in_dim: int, hidden_dim: int, out_dim: int, num_layers: int,
             generator: torch.Generator,
             device: torch.device | str = "cpu") -> MLP:
    """He-uniform weights, zero biases.  ``num_layers`` counts weight
    matrices: [in, hidden], ..., [hidden, out]."""
    dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
    ws, bs = [], []
    for i in range(num_layers):
        bound = (6.0 / dims[i]) ** 0.5
        u = torch.rand((dims[i], dims[i + 1]), generator=generator,
                       device=generator.device)
        ws.append(((2.0 * u - 1.0) * bound).to(device))
        bs.append(torch.zeros((dims[i + 1],), device=device))
    return MLP(ws, bs)


def mlp_apply(mlp: MLP, x: torch.Tensor,
              hidden_activation: Callable = torch.relu,
              output_activation: Optional[Callable] = None,
              compute_dtype: torch.dtype = torch.bfloat16,
              impl: str = "xla") -> torch.Tensor:
    """[..., in] → [..., out] in float32.

    ``impl="pallas"`` or ``"pallas-fused"`` sends a relu MLP to the fused
    MLP kernel (``ops/cuda/fused_mlp.py``), which keeps the activations on
    chip; ``"xla"`` runs one matmul per layer.
    """
    ws, bs = list(mlp.w), list(mlp.b)
    n = len(ws)
    if impl in ("pallas", "pallas-fused") and hidden_activation is torch.relu:
        from .cuda.fused_mlp import fused_mlp
        flat = x.reshape(-1, x.shape[-1]).float().contiguous()
        wbs = []
        for w, b in zip(ws, bs):
            wbs += [w, b.reshape(1, -1)]
        h = fused_mlp(flat, wbs, compute_dtype)
        h = h.reshape(*x.shape[:-1], h.shape[-1])
    else:
        h = x
        for i in range(n):
            h = mm_f32acc(h, ws[i], compute_dtype) + bs[i]
            if i < n - 1:
                h = hidden_activation(h).to(compute_dtype)
        h = h.float()
    if output_activation is not None:
        h = output_activation(h)
    return h
