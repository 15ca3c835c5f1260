"""Phi-2 decoder in PyTorch, numerically matching the JAX package's
`models/phi.py` (itself held to HF `PhiForCausalLM`).

The one prismatic-zoo LLM backbone that is not Llama-shaped (`phi-2+3b`):
  - LayerNorm (scale + bias) instead of RMSNorm, eps 1e-5;
  - parallel residual: attention and MLP both read the same
    input_layernorm output and are added to the residual in one step;
  - partial rotary: RoPE on the first `rotary_dim` (0.4 * head_dim)
    channels of q/k, the rest pass through;
  - biased q/k/v/dense/fc1/fc2 projections and a biased lm_head;
  - MLP = fc1 -> gelu (tanh approximation, f32) -> fc2, no gate.

Under a model axis (`mesh`) the params are this rank's slices
(parallel.shard_params, `phi_param_specs`): q/k/v and fc1 column-parallel
with their biases, o and fc2 row-parallel with their biases added after the
sum, lm_head's weight and bias split on the vocab.

Attention runs `ops.attention.attend`: the B1/B2 kernels wherever they
take the input (bf16 on CUDA; Phi-2's head dim 80 included), else `mha`
("xla" or "chunked"). `attn_impl="flash"` runs the kernels on every call
(their plain versions on the CPU), where the JAX package refuses it for
head dims other than 128.

Params:
  embed:   [V, D]
  layers:  stacked {ln_scale, ln_bias, q_w, q_b, k_w, k_b, v_w, v_b,
           o_w, o_b, fc1_w, fc1_b, fc2_w, fc2_b}   (weights input-major)
  norm:    {scale [D], bias [D]}
  lm_head: {w [D, V], b [V]}
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attend, causal_bias, padding_bias
from ..ops.norm import layer_norm
from .config import PhiConfig
from .convert import getter, stacked_layers
from .llama import rope_cos_sin, rotate_half
from ..parallel.tensor_parallel import copy_to_model, local_count, reduce_from_model
from ..utils.profiling import count
from .param_tree import ParamTree
from .vit import _normal


def _apply_partial_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        rotary_dim: int) -> torch.Tensor:
    """x: [B, H, S, hd]; rotate the first rotary_dim channels, pass the rest
    (HF PhiAttention's query_rot / query_pass split)."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    rot, passthrough = x[..., :rotary_dim], x[..., rotary_dim:]
    rot = rot * cos + rotate_half(rot) * sin
    return torch.cat([rot, passthrough], dim=-1)


def _phi_block(cfg: PhiConfig, x: torch.Tensor, layers: Dict, li: int,
               bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mesh=None) -> torch.Tensor:
    """One Phi block on layer `li` of the stacked params (this rank's heads
    and fc1 slice under a model axis)."""
    count("blocks.llm")
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = local_count(cfg.num_heads, mesh, "num_heads")
    p = {name: t[li] for name, t in layers.items()}

    y = copy_to_model(layer_norm(x, p["ln_scale"], p["ln_bias"], cfg.ln_eps), mesh)

    def heads(name):
        return (y @ p[f"{name}_w"] + p[f"{name}_b"]).reshape(b, s, h, hd).transpose(1, 2)

    q = _apply_partial_rope(heads("q"), cos, sin, cfg.rotary_dim)
    k = _apply_partial_rope(heads("k"), cos, sin, cfg.rotary_dim)
    v = heads("v")
    attn = attend(q, k, v, bias, cfg.attn_impl)
    attn = reduce_from_model(attn.transpose(1, 2).reshape(b, s, h * hd) @ p["o_w"], mesh) + p["o_b"]

    # parallel residual: the MLP reads the same normed input as attention
    mlp = F.gelu((y @ p["fc1_w"] + p["fc1_b"]).float(), approximate="tanh").to(x.dtype)
    mlp = reduce_from_model(mlp @ p["fc2_w"], mesh) + p["fc2_b"]
    return x + attn + mlp


def phi_apply(
    params: Dict,
    cfg: PhiConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits_tail: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """inputs_embeds [B, S, D] -> f32 logits (the contract of llama_apply)."""
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        positions = torch.arange(s, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta)
    bias = causal_bias(s, s, device=dev)
    if attention_mask is not None:
        bias = bias + padding_bias(attention_mask)

    x = inputs_embeds
    layers = params["layers"]
    for li in range(len(layers["q_w"])):  # a stack, or a list of per-layer leaves
        if remat:
            # no block draws random numbers, so no RNG state is stashed (a CUDA graph's capture refuses it)
            x = checkpoint(_phi_block, cfg, x, layers, li, bias, cos, sin, mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _phi_block(cfg, x, layers, li, bias, cos, sin, mesh)
    x = layer_norm(x, params["norm"]["scale"], params["norm"]["bias"], cfg.ln_eps)
    if logits_tail is not None:
        x = x[:, s - logits_tail :, :]
    return (copy_to_model(x, mesh) @ params["lm_head"]["w"] + params["lm_head"]["b"]).float()


class Phi(ParamTree):
    """The Phi stack's params under the JAX names."""

    def __init__(self, cfg: PhiConfig, tree: Dict) -> None:
        super().__init__(tree)
        self.cfg = cfg


def init_phi_params(gen: torch.Generator, cfg: PhiConfig, dtype=torch.float32,
                    device: Optional[torch.device] = None) -> Dict:
    """Random init with the JAX package's shapes and scales, drawn from `gen`
    on `device` (the generator's device by default)."""
    device = gen.device if device is None else device
    d, l, inter, v = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size, cfg.vocab_size

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": normal((v, d)),
        "layers": {
            "ln_scale": ones(l, d), "ln_bias": zeros(l, d),
            "q_w": normal((l, d, d)), "q_b": zeros(l, d),
            "k_w": normal((l, d, d)), "k_b": zeros(l, d),
            "v_w": normal((l, d, d)), "v_b": zeros(l, d),
            "o_w": normal((l, d, d)), "o_b": zeros(l, d),
            "fc1_w": normal((l, d, inter)), "fc1_b": zeros(l, inter),
            "fc2_w": normal((l, inter, d)), "fc2_b": zeros(l, d),
        },
        "norm": {"scale": ones(d), "bias": zeros(d)},
        "lm_head": {"w": normal((d, v)), "b": zeros(v)},
    }


PHI_LAYER_NAMES = {
    "ln_scale": "input_layernorm.weight", "ln_bias": "input_layernorm.bias",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.dense.weight", "o_b": "self_attn.dense.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


def convert_phi(state: Mapping[str, torch.Tensor], cfg: PhiConfig,
                prefix: str = "language_model.", device="cpu") -> Dict:
    """HF `PhiForCausalLM` state dict -> the stacked tree on `device`."""
    get = getter(state, prefix, device)
    return {
        "embed": get("model.embed_tokens.weight"),
        "layers": stacked_layers(get, cfg.num_layers, "model.layers.{}.", PHI_LAYER_NAMES),
        "norm": {"scale": get("model.final_layernorm.weight"),
                 "bias": get("model.final_layernorm.bias")},
        "lm_head": {"w": get("lm_head.weight").T.contiguous(), "b": get("lm_head.bias")},
    }
