"""Differentiable adversarial-patch compositing (the JAX package's
`ops/patch_ops.py`): paste at (x, y) -> optional affine warp (bilinear,
border padding) -> `where(canvas < -20)` composite.

Patch layout is [ph, pw, 3] (HWC) in [0, 1]; images are [B, H, W, 3]. The
random draws of a batch (placement, affine matrix, rescale factor per image)
are an argument, `PatchDraws`; `draw_patch_params` draws them from a
`torch.Generator` on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.constants import CANVAS_FILL, COMPOSITE_THRESHOLD
from .grid_sample import affine_warp, random_affine_matrix

SCALE_RANGE = (0.61, 1.39)


class PatchDraws(NamedTuple):
    """One batch's draws: xy [B, 2] int (x, y); matrix [B, 3, 3] f32, read
    when `geometry`; scale [B] f32, read when `resize_patch`."""

    xy: torch.Tensor
    matrix: torch.Tensor
    scale: torch.Tensor


def paste_patch(patch: torch.Tensor, x: int, y: int, height: int, width: int,
                fill: float = CANVAS_FILL) -> torch.Tensor:
    """`patch` [ph, pw, C] at (x, y) on a `fill` canvas [H, W, C]; the start
    is clamped so the patch fits (dynamic_update_slice semantics)."""
    ph, pw, c = patch.shape
    x = min(max(int(x), 0), width - pw)
    y = min(max(int(y), 0), height - ph)
    canvas = torch.full((height, width, c), fill, dtype=patch.dtype, device=patch.device)
    canvas[y : y + ph, x : x + pw] = patch
    return canvas


def paste_patch_scaled(patch: torch.Tensor, x: int, y: int, scale: torch.Tensor,
                       height: int, width: int, fill: float = CANVAS_FILL) -> torch.Tensor:
    """Paste the patch bilinearly rescaled by `scale` at (x, y): output pixel
    (i, j) samples patch coords u = (j - x) / scale, v = (i - y) / scale where
    0 <= u <= pw - 1 and 0 <= v <= ph - 1, else `fill`."""
    ph, pw, _ = patch.shape
    dev = patch.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    jj = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    ii = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    u = (jj - float(x)) / scale
    v = (ii - float(y)) / scale
    inside = (u >= 0) & (u <= pw - 1) & (v >= 0) & (v <= ph - 1)
    u = u.clamp(0.0, pw - 1.0)
    v = v.clamp(0.0, ph - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    wu = (u - u0).to(patch.dtype)[..., None]
    wv = (v - v0).to(patch.dtype)[..., None]

    def gather(vi, ui):
        return patch[vi.clamp(0, ph - 1).long(), ui.clamp(0, pw - 1).long()]

    p00, p01 = gather(v0, u0), gather(v0, u0 + 1)
    p10, p11 = gather(v0 + 1, u0), gather(v0 + 1, u0 + 1)
    top = p00 * (1 - wu) + p01 * wu
    bot = p10 * (1 - wu) + p11 * wu
    vals = top * (1 - wv) + bot * wv
    return torch.where(inside[..., None], vals, torch.full((), fill, dtype=patch.dtype, device=dev))


def composite(canvas: torch.Tensor, image: torch.Tensor,
              threshold: float = COMPOSITE_THRESHOLD) -> torch.Tensor:
    """`where(canvas < threshold, image, canvas)`: the geometry-path blend
    (interpolated canvas borders above the threshold count as patch)."""
    return torch.where(canvas < threshold, image, canvas)


def composite_exact(canvas: torch.Tensor, image: torch.Tensor,
                    fill: float = CANVAS_FILL) -> torch.Tensor:
    """`where(canvas != fill, canvas, image)`: the no-affine paste blend."""
    return torch.where(canvas != fill, canvas, image)


def random_placement(gen: Optional[torch.Generator], height: int, width: int,
                     ph: int, pw: int) -> Tuple[int, int]:
    """x ~ U{0..W-pw}, y ~ U{0..H-ph}."""
    x = int(torch.randint(0, width - pw + 1, (), generator=gen))
    y = int(torch.randint(0, height - ph + 1, (), generator=gen))
    return x, y


def draw_patch_params(gen: Optional[torch.Generator], batch: int, height: int, width: int,
                      ph: int, pw: int, resize_patch: bool = False,
                      scale_range: Tuple[float, float] = SCALE_RANGE) -> PatchDraws:
    """A batch's draws, per image in the order of the JAX
    `apply_patch_single`: placement, rescale factor, affine matrix."""
    xy, scales, mats = [], [], []
    for _ in range(batch):
        if resize_patch:
            # the scaled patch stays inside the frame at the largest scale
            max_side = int(math.ceil(max(ph, pw) * scale_range[1]))
            x = int(torch.randint(0, max(width - max_side, 1), (), generator=gen))
            y = int(torch.randint(0, max(height - max_side, 1), (), generator=gen))
        else:
            x, y = random_placement(gen, height, width, ph, pw)
        xy.append((x, y))
        u = float(torch.rand((), generator=gen))
        scales.append(scale_range[0] + (scale_range[1] - scale_range[0]) * u)
        mats.append(random_affine_matrix(1, gen)[0])
    return PatchDraws(xy=torch.tensor(xy, dtype=torch.int64),
                      matrix=torch.stack(mats),
                      scale=torch.tensor(scales, dtype=torch.float32))


def apply_patch_batch(images: torch.Tensor, patch: torch.Tensor, draws: PatchDraws,
                      geometry: bool = True, resize_patch: bool = False) -> torch.Tensor:
    """Place (and optionally rescale and warp) the patch on each image
    [B, H, W, 3] with that image's draws; differentiable in the patch."""
    b, h, w, _ = images.shape
    xy = draws.xy.tolist()
    if resize_patch:
        canvas = torch.stack([
            paste_patch_scaled(patch, xy[i][0], xy[i][1], draws.scale[i], h, w) for i in range(b)
        ])
    else:
        canvas = torch.stack([paste_patch(patch, xy[i][0], xy[i][1], h, w) for i in range(b)])
    if geometry:
        canvas = affine_warp(canvas, draws.matrix.to(images.device), padding_mode="border")
        return composite(canvas, images)
    return composite_exact(canvas, images)


def quantize_patch_u8(patch: np.ndarray) -> np.ndarray:
    """float patch in [0, 1] -> uint8 by truncation (torchvision's
    `mul(255).byte()` round trip)."""
    patch = np.asarray(patch)
    return (np.clip(patch, 0.0, 1.0) * 255.0).astype(np.uint8)
