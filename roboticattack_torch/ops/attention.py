"""Attention primitive of the vision towers: QK^T -> fp32 softmax -> PV."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -(2.0**30)  # large finite negative; avoids NaN from all-masked rows


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D]; bias broadcastable to
    [B, H, Sq, Skv] (additive, fp32). Returns [B, Hq, Sq, D] in q.dtype.

    Scores are accumulated and kept in fp32 (the operands are upcast, so a
    bf16 product is exact and no bf16 rounding of the scores occurs); the
    probabilities are cast to q.dtype before P·V."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if hq != hkv:
        group = hq // hkv
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(q.dtype), v)
