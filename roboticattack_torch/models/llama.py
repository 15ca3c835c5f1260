"""Llama-2 building blocks in PyTorch, numerically matching the JAX package's
`models/llama.py` (RMSNorm, HF non-interleaved RoPE) and the Llama param
layout.

Params (the JAX pytree layout):
  embed:   [V, D]
  layers:  stacked {attn_norm, q_w, k_w, v_w, o_w, mlp_norm, gate_w, up_w, down_w}
           (stored input-major [D_in, D_out]; the decode cooks them to
           [L, out, in], models/decode.py decode_layout_params)
  norm:    [D]
  lm_head: [D, V]
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .config import LlamaConfig
from .param_tree import ParamTree
from .vit import _normal


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised value is cast to x.dtype BEFORE the
    weight multiply (HF LlamaRMSNorm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return weight * normed


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [S] (or [B, S]) -> cos/sin of shape [..., S, head_dim], fp32.
    HF convention: freqs duplicated as cat(freqs, freqs) (non-interleaved)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q/k: [B, H, S, hd]; cos/sin: [S, hd] or [B, S, hd] -> broadcast over
    heads. cos/sin are cast to q.dtype first."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    cos, sin = cos.to(q.dtype), sin.to(q.dtype)
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out, k_out


class Llama(ParamTree):
    """The Llama stack's params under the JAX names (`embed`, `layers.q_w`,
    ..., `lm_head`, and the `*_scale` buffers once quantized). The serving
    forward is models/decode.py greedy_decode_actions over `tree()`."""

    def __init__(self, cfg: LlamaConfig, tree: Dict) -> None:
        super().__init__(tree)
        self.cfg = cfg


def init_llama_params(
    gen: torch.Generator, cfg: LlamaConfig, dtype=torch.float32,
    device: Optional[torch.device] = None,
) -> Dict:
    """Random init with the JAX package's shapes and scales, drawn from `gen`
    on `device`."""
    device = gen.device if device is None else device
    d, l, inter, v = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size, cfg.vocab_size
    hd, h, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": normal((v, d)),
        "layers": {
            "attn_norm": ones((l, d)),
            "q_w": normal((l, d, h * hd)),
            "k_w": normal((l, d, hkv * hd)),
            "v_w": normal((l, d, hkv * hd)),
            "o_w": normal((l, h * hd, d)),
            "mlp_norm": ones((l, d)),
            "gate_w": normal((l, d, inter)),
            "up_w": normal((l, d, inter)),
            "down_w": normal((l, inter, d)),
        },
        "norm": ones((d,)),
        "lm_head": normal((d, v)),
    }
