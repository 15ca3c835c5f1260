"""Label masking and rewriting shared by the three attacks (the JAX package's
`utils/labels.py`, as torch ops on [B, S] label tensors).

Random draws come in as arguments: `change_target` takes its coin tensor,
which `draw_coin` draws from a `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .action_tokenizer import encode_actions_np
from .constants import (
    ACTION_DIM,
    ACTION_TOKEN_BEGIN_IDX,
    ACTION_TOKEN_MAX,
    ACTION_TOKEN_MIN,
    ACTION_TOKEN_ZERO,
    EOS_TOKEN_ID,
    IGNORE_INDEX,
)


def maskidx_to_onehot(maskidx: Sequence[int], length: int = ACTION_DIM + 1) -> np.ndarray:
    """Boolean vector over the 7 action slots (+1 EOS slot) selected by
    ``--maskidx``."""
    sel = np.zeros(length, dtype=bool)
    for i in maskidx:
        sel[int(i)] = True
    return sel


def build_tma_target_tokens(target_action: np.ndarray, maskidx: Sequence[int]) -> np.ndarray:
    """TMA's per-example target: 7 action token ids + EOS, every slot not in
    maskidx set to IGNORE_INDEX."""
    tokens = encode_actions_np(np.asarray(target_action, dtype=np.float64))
    target = np.concatenate([tokens, np.array([EOS_TOKEN_ID], dtype=np.int64)])
    keep = maskidx_to_onehot(maskidx, length=target.shape[0])
    return np.where(keep, target, IGNORE_INDEX).astype(np.int32)


def _slots(mask: torch.Tensor, length: int) -> torch.Tensor:
    """Each position's index within its row's selected subsequence, clipped
    to [0, length - 1]."""
    return (torch.cumsum(mask.long(), dim=-1) - 1).clamp(0, length - 1)


def overwrite_with_target(labels: torch.Tensor, target_tokens: torch.Tensor) -> torch.Tensor:
    """Replace each row's non-ignored labels, in order, with
    ``target_tokens`` (length action_dim + 1); IGNORE stays."""
    valid = labels != IGNORE_INDEX
    target = torch.as_tensor(target_tokens, device=labels.device).to(labels.dtype)
    return torch.where(valid, target[_slots(valid, target.shape[0])], labels)


def mask_labels(labels: torch.Tensor, maskidx: Sequence[int]) -> torch.Tensor:
    """UADA/UPA masking: action-token labels outside the maskidx slots become
    IGNORE; EOS labels stay."""
    is_action = labels > ACTION_TOKEN_BEGIN_IDX
    onehot = torch.as_tensor(maskidx_to_onehot(maskidx, ACTION_DIM), device=labels.device)
    keep = onehot[_slots(is_action, ACTION_DIM)]
    return torch.where(is_action & ~keep, torch.full_like(labels, IGNORE_INDEX), labels)


def change_target(labels: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """UPA 'guide' targets, every condition read from the original labels:
    the zero bin flips to ACTION_TOKEN_MIN where `coin` (bool, labels' shape)
    is set and to ACTION_TOKEN_MAX elsewhere; labels above it flip to the +1
    token, all other valid labels (EOS included) to the -1 token."""
    valid = labels != IGNORE_INDEX
    coin = coin.to(labels.device)
    lo = torch.full_like(labels, ACTION_TOKEN_MIN)
    hi = torch.full_like(labels, ACTION_TOKEN_MAX)
    out = torch.where(valid & (labels == ACTION_TOKEN_ZERO), torch.where(coin, lo, hi), labels)
    out = torch.where(valid & (labels > ACTION_TOKEN_ZERO), lo, out)
    return torch.where(valid & (labels < ACTION_TOKEN_ZERO), hi, out)


def draw_coin(shape, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The fair coin of `change_target`, drawn on the CPU from `gen`."""
    return torch.rand(shape, generator=gen) < 0.5


def extract_action_tokens(labels: torch.Tensor) -> torch.Tensor:
    """Each row's 7 action-token labels, in order, as [B, 7] (rows hold
    exactly ACTION_DIM action tokens)."""
    is_action = labels > ACTION_TOKEN_BEGIN_IDX
    order = torch.argsort((~is_action).to(torch.uint8), dim=-1, stable=True)
    return torch.gather(labels, -1, order[:, :ACTION_DIM])


def gripper_open_rows(labels: torch.Tensor) -> torch.Tensor:
    """Boolean [B]: rows whose gripper action token is the +1 token."""
    return extract_action_tokens(labels)[:, ACTION_DIM - 1] == ACTION_TOKEN_MIN
