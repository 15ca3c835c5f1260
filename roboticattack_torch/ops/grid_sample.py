"""Affine warp by gather-based bilinear sampling, and the patch augmentation
matrices.

`affine_warp` transcribes the JAX package's `ops/grid_sample.py` arithmetic
(align_corners=False normalized coordinates, border or zeros padding, four
gathers), batched over a leading axis. It is deliberately not
`F.affine_grid` + `F.grid_sample`: those compute the same map with another
rounding (5.8e-4 off on a -100-filled canvas), and the composite's
`canvas < -20` test can flip on a pixel interpolated near -20.
Differentiable with respect to the image.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def affine_warp(image: torch.Tensor, matrix: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Warp images [B, H, W, C] by per-image 2x3 (or 3x3) matrices [B, 2|3, 3]
    mapping output normalized coordinates to input ones (the theta of
    `F.affine_grid`)."""
    b, h, w, _ = image.shape
    m = matrix[:, :2, :].to(torch.float32)
    xs = ((2.0 * torch.arange(w, dtype=torch.float32, device=image.device) + 1.0) / w - 1.0)[None, None, :]
    ys = ((2.0 * torch.arange(h, dtype=torch.float32, device=image.device) + 1.0) / h - 1.0)[None, :, None]

    def coef(i, j):
        return m[:, i, j][:, None, None]

    gx = coef(0, 0) * xs + coef(0, 1) * ys + coef(0, 2)  # [B, H, W]
    gy = coef(1, 0) * xs + coef(1, 1) * ys + coef(1, 2)
    ix = ((gx + 1.0) * w - 1.0) / 2.0
    iy = ((gy + 1.0) * h - 1.0) / 2.0
    if padding_mode == "border":
        ix = ix.clamp(0.0, w - 1.0)
        iy = iy.clamp(0.0, h - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode={padding_mode}")

    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx = (ix - x0).to(image.dtype)[..., None]
    wy = (iy - y0).to(image.dtype)[..., None]
    bidx = torch.arange(b, device=image.device)[:, None, None]

    def gather(yi, xi):
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        vals = image[bidx, yc, xc]  # [B, H, W, C]
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            vals = torch.where(inside[..., None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        return vals

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def rotation_matrix(theta_deg: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation about the image center in normalized
    coordinates."""
    theta = torch.deg2rad(torch.as_tensor(theta_deg, dtype=torch.float32))
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def shear_matrix(shx: torch.Tensor, shy: torch.Tensor) -> torch.Tensor:
    shx = torch.as_tensor(shx, dtype=torch.float32)
    shy = torch.as_tensor(shy, dtype=torch.float32)
    zero, one = torch.zeros_like(shx), torch.ones_like(shx)
    return torch.stack([
        torch.stack([one, shx, zero], -1),
        torch.stack([shy, one, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def random_affine_matrix(
    n: int,
    gen: Optional[torch.Generator] = None,
    max_angle: float = 30.0,
    max_shear: float = 0.2,
    identity_prob: float = 0.2,
) -> torch.Tensor:
    """[n, 3, 3] augmentation matrices on the CPU: with prob `identity_prob`
    the identity, else shear(shx, shy) @ rotate(angle), angle ~ U(-30, 30),
    shx, shy ~ U(-0.2, 0.2). Per matrix the draws are the identity coin,
    angle, shx, shy, in that order."""
    u = torch.rand((n, 4), generator=gen)
    take_identity = u[:, 0] < identity_prob
    angle = (2.0 * u[:, 1] - 1.0) * max_angle
    shx = (2.0 * u[:, 2] - 1.0) * max_shear
    shy = (2.0 * u[:, 3] - 1.0) * max_shear
    m = shear_matrix(shx, shy) @ rotation_matrix(angle)
    return torch.where(take_identity[:, None, None], torch.eye(3), m)


def fixed_affine_matrix(angle_deg: float, shx: float, shy: float) -> np.ndarray:
    """Host-side matrix for evaluation-time fixed-geometry pastes."""
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta), np.sin(theta)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
    sh = np.array([[1, shx, 0], [shy, 1, 0], [0, 0, 1]], dtype=np.float32)
    return sh @ r
