"""Attention of every transformer block (`attend`: the hand-written
B1/B2 kernels wherever they take the input, else plain attention), plain
attention: QK^T -> fp32 softmax -> PV (`mha`), and the additive causal and
padding biases."""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import count, span
from .flash_attention import kernel_shape_problem, mha_flash

NEG_INF = -(2.0**30)  # large finite negative; avoids NaN from all-masked rows


ATTN_IMPLS = ("xla", "chunked", "flash")


def takes_kernels(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether B1/B2 (ops/flash_attention.py) take this self-attention: CUDA
    q/k/v of the shapes and dtype they take (kernel_shape_problem: bf16,
    Hkv dividing Hq, head dim 64/72/80/128, 1 <= S <= 2048), and no bias or
    one [B, 1, S, S] (or [1, 1, S, S], shared by the rows)."""
    if not q.is_cuda or kernel_shape_problem(q, k, v) is not None:
        return False
    b, _, s, _ = q.shape
    return bias is None or (bias.dim() == 4 and bias.shape[0] in (1, b) and tuple(bias.shape[1:]) == (1, s, s))


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """One block's attention, in the `attention` span and counted once in
    `attention.calls`: the B1/B2 kernels (`mha_flash`) where
    `takes_kernels`, else `mha`. impl "flash" always takes `mha_flash`,
    which raises on what the kernels refuse (and runs their plain versions
    on the CPU); "chunked" means the same as "xla". Counts
    `attention.kernel` 0 here (each B1 launch adds 1), so a program that
    launches nothing reads 0."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={impl!r} is not supported (one of {', '.join(ATTN_IMPLS)})")
    with span("attention"):
        count("attention.calls")
        count("attention.kernel", 0)
        if impl == "flash" or takes_kernels(q, k, v, bias):
            return mha_flash(q, k, v, bias=bias)
        return mha(q, k, v, bias=bias)


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
