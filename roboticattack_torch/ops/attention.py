"""Plain attention: QK^T -> fp32 softmax -> PV (`mha`, the vision towers'
and the `attn_impl="xla"` decoder's), its query-chunked form (`mha_chunked`,
`attn_impl="chunked"`), and the additive causal and padding biases."""

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


def mha_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    chunk: int = 64,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """`mha` one block of `chunk` queries at a time (the same fp32 softmax
    per row); a single block when sq is not a multiple of chunk above it."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sq % chunk != 0 or sq <= chunk:
        return mha(q, k, v, bias=bias, scale=scale)
    if bias is not None:
        bias = bias.expand(b, bias.shape[1], sq, skv)
    outs = [
        mha(q[:, :, i : i + chunk], k, v,
            bias=None if bias is None else bias[:, :, i : i + chunk], scale=scale)
        for i in range(0, sq, chunk)
    ]
    return torch.cat(outs, dim=2)


def causal_bias(sq: int, skv: int, device=None) -> torch.Tensor:
    """[1, 1, sq, skv] additive causal mask (query i attends keys <= i +
    skv - sq)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(skv, device=device)[None, :]
    allowed = ki <= qi + (skv - sq)
    return torch.where(allowed, 0.0, NEG_INF)[None, None].float()


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """attention_mask: [B, Skv] with 1 = attend. Returns [B, 1, 1, Skv]."""
    return torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG_INF).float()
