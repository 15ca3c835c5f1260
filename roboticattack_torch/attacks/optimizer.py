"""Patch optimizer: AdamW with transformers' semantics (bias-corrected step
size, eps outside the sqrt, decoupled weight decay), signed-gradient PGD,
and the cosine-with-warmup schedule (the JAX package's
`attacks/optimizer.py`).

The optimizer steps once per inner step while the schedule steps once per
outer iteration: the runner passes the outer iteration's LR into the step.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor  # int32 scalar


def adam_init(patch: torch.Tensor) -> AdamState:
    return AdamState(m=torch.zeros_like(patch), v=torch.zeros_like(patch),
                     count=torch.zeros((), dtype=torch.int32, device=patch.device))


def adamw_update(
    grad: torch.Tensor,
    state: AdamState,
    patch: torch.Tensor,
    lr: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-6,
    weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, AdamState]:
    """One AdamW step, in f32: returns (new_patch, new_state)."""
    count = state.count + 1
    m = b1 * state.m + (1.0 - b1) * grad
    v = b2 * state.v + (1.0 - b2) * grad * grad
    cf = count.float()
    step_size = lr * torch.sqrt(1.0 - torch.pow(b2, cf)) / (1.0 - torch.pow(b1, cf))
    new_patch = patch - step_size * m / (torch.sqrt(v) + eps)
    if weight_decay > 0.0:
        new_patch = new_patch - lr * weight_decay * patch
    return new_patch, AdamState(m=m, v=v, count=count)


def pgd_update(grad: torch.Tensor, patch: torch.Tensor, alpha: float) -> torch.Tensor:
    """Signed-gradient PGD step."""
    return patch - alpha * torch.sign(grad)


def cosine_schedule_with_warmup(
    step: int, base_lr: float, warmup_steps: int, total_steps: int, num_cycles: float = 0.5
) -> float:
    """transformers.get_cosine_schedule_with_warmup, on the host. `step` is
    the scheduler's step count = floor(outer_iter / accumulate)."""
    if step < warmup_steps:
        return base_lr * float(step) / float(max(1, warmup_steps))
    progress = float(step - warmup_steps) / float(max(1, total_steps - warmup_steps))
    return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
