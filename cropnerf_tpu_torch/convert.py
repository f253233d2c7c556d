"""Parameters from the JAX package's params pytree.

``params_from_jax`` takes the tree as nested dicts and lists of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and builds the
port's :class:`CropNeRFParams`.  Both sides keep MLP weights as [in, out],
so the conversion is a plain walk over ``field``, ``camera_opt`` and
``proposal_{i}``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.field import HASH_NOT_PORTED
from .models.model import CropNeRFParams
from .models.proposal import ProposalField
from .models.vanilla import VanillaField
from .ops.mlp import MLP


def params_from_jax(tree: Mapping, device: torch.device | str = "cuda"
                    ) -> CropNeRFParams:
    device = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def mlp(d: Mapping) -> MLP:
        return MLP([tensor(w) for w in d["w"]], [tensor(b) for b in d["b"]])

    f = tree["field"]
    if "grid" in f:
        raise NotImplementedError(HASH_NOT_PORTED)
    field = VanillaField(
        mlp_base=mlp(f["mlp_base"]), mlp_top=mlp(f["mlp_top"]),
        mlp_color=mlp(f["mlp_color"]), mlp_semantic=mlp(f["mlp_semantic"]),
        appearance=tensor(f["appearance"]) if "appearance" in f else None)
    n_prop = sum(1 for k in tree if k.startswith("proposal_"))
    proposals = []
    for i in range(n_prop):
        p = tree[f"proposal_{i}"]
        if "grid" in p:
            raise NotImplementedError(HASH_NOT_PORTED)
        proposals.append(ProposalField(mlp(p["mlp"])))
    return CropNeRFParams(field, tensor(tree["camera_opt"]), proposals)
