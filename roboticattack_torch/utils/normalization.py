"""Dual image normalization for the fused DINOv2 + SigLIP vision backbone."""

from __future__ import annotations

import torch

from .constants import DINO_MEAN, DINO_STD, SIGLIP_MEAN, SIGLIP_STD


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
