"""Llama-2 decoder in PyTorch, numerically matching the JAX package's
`models/llama.py` (RMSNorm, HF non-interleaved RoPE, the training-style
forward `llama_apply` with its `attn_impl` dispatch, shifted CE) and the
Llama param layout.

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_bias, mha, mha_chunked, padding_bias
from ..ops.flash_attention import mha_flash
from ..utils.constants import IGNORE_INDEX
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


def _attention(cfg: LlamaConfig, q, k, v, bias):
    """The `attn_impl` dispatch: "flash" -> the B1/B2 kernels
    (ops/flash_attention.py), "chunked" -> mha_chunked, otherwise (the JAX
    config value "xla") plain mha under autograd."""
    if cfg.attn_impl == "flash":
        return mha_flash(q, k, v, bias=bias)
    if cfg.attn_impl == "chunked" and cfg.attn_chunk is not None:
        return mha_chunked(q, k, v, bias=bias, chunk=cfg.attn_chunk)
    return mha(q, k, v, bias=bias)


def decoder_block(cfg: LlamaConfig, x: torch.Tensor, layers: Dict, li: int,
                  bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One pre-norm decoder block on layer `li` of the stacked params. SiLU
    runs in the model dtype (HF LlamaMLP), unlike the decode's f32 SiLU."""
    b, s, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {name: t[li] for name, t in layers.items()}

    y = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q = (y @ p["q_w"]).reshape(b, s, h, hd).transpose(1, 2)
    k = (y @ p["k_w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (y @ p["v_w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    attn = _attention(cfg, q, k, v, bias)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    x = x + attn @ p["o_w"]

    y = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    gate = F.silu(y @ p["gate_w"])
    return x + (gate * (y @ p["up_w"])) @ p["down_w"]


def llama_apply(
    params: Dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits_tail: Optional[int] = None,
) -> torch.Tensor:
    """inputs_embeds [B, S, D] -> f32 logits [B, S, V], or [B, k, V] for the
    last k positions with `logits_tail=k`. `remat` recomputes each decoder
    block in the backward (torch.utils.checkpoint, non-reentrant)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        positions = torch.arange(s, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    bias = causal_bias(s, s, device=dev)
    if attention_mask is not None:
        bias = bias + padding_bias(attention_mask)

    x = inputs_embeds
    layers = params["layers"]
    for li in range(layers["q_w"].shape[0]):
        if remat:
            x = checkpoint(decoder_block, cfg, x, layers, li, bias, cos, sin, use_reentrant=False)
        else:
            x = decoder_block(cfg, x, layers, li, bias, cos, sin)
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    if logits_tail is not None:
        x = x[:, s - logits_tail :, :]
    return (x @ params["lm_head"]).float()


def embed_tokens(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted CE: logits[:, :-1] predict labels[:, 1:]; IGNORE positions
    excluded; mean over valid tokens, f32."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    logprobs = torch.log_softmax(shift_logits, dim=-1)
    token_ll = torch.gather(logprobs, -1, safe[..., None])[..., 0]
    loss_sum = -torch.where(valid, token_ll, torch.zeros_like(token_ll)).sum()
    return loss_sum / valid.sum().clamp(min=1)


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
