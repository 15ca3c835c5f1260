"""Action normalization (BOUNDS_Q99) and the dual image normalization of the
fused DINOv2 + SigLIP vision backbone.

BOUNDS_Q99 (prismatic/vla/datasets/rlds/utils/data_utils.py:61-103):
clip(2 * (x - q01) / (q99 - q01 + 1e-8) - 1, -1, 1) where the mask is True;
its inverse (prismatic/extern/hf/modeling_prismatic.py:527-534):
0.5 * (a + 1) * (q99 - q01) + q01. Both take torch tensors or numpy arrays
and return the same kind.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .constants import DINO_MEAN, DINO_STD, SIGLIP_MEAN, SIGLIP_STD


def _q99_args(actions, q01, q99, mask):
    """(where, q01, q99, mask) in the kind of `actions`; no mask = all True."""
    if isinstance(actions, torch.Tensor):
        q01, q99 = (torch.as_tensor(q, dtype=actions.dtype, device=actions.device) for q in (q01, q99))
        mask = (torch.ones_like(q01, dtype=torch.bool) if mask is None
                else torch.as_tensor(mask, dtype=torch.bool, device=actions.device))
        return torch.where, q01, q99, mask
    q01, q99 = np.asarray(q01), np.asarray(q99)
    mask = np.ones_like(q01, dtype=bool) if mask is None else np.asarray(mask, bool)
    return np.where, q01, q99, mask


def normalize_actions_q99(actions, q01, q99, mask: Optional[object] = None):
    """Dataset-statistics normalization used by the RLDS pipeline."""
    where, q01, q99, mask = _q99_args(actions, q01, q99, mask)
    normed = (2.0 * (actions - q01) / (q99 - q01 + 1e-8) - 1.0).clip(-1.0, 1.0)
    return where(mask, normed, actions)


def unnormalize_actions_q99(actions, q01, q99, mask: Optional[object] = None):
    """Inverse map used by `predict_action` before driving the robot."""
    where, q01, q99, mask = _q99_args(actions, q01, q99, mask)
    return where(mask, 0.5 * (actions + 1.0) * (q99 - q01) + q01, actions)


def normalize_image(images: torch.Tensor, mean, std) -> torch.Tensor:
    """images: [..., H, W, 3] in [0, 1]."""
    mean = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def dual_normalize(images: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0,1] -> [..., 2, H, W, 3]: (DINO-normed,
    SigLIP-normed). Axis -4 indexes the backbone (channels-last layout, as in
    the JAX package, so the tests compare like with like)."""
    dino = normalize_image(images, DINO_MEAN, DINO_STD)
    sig = normalize_image(images, SIGLIP_MEAN, SIGLIP_STD)
    return torch.stack([dino, sig], dim=-4)
