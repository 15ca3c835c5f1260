"""Llama-2 decoder in PyTorch, numerically matching the JAX package's
`models/llama.py` (RMSNorm, HF non-interleaved RoPE, the training-style
forward `llama_apply` with its `attn_impl` dispatch, shifted CE) and the
Llama param layout.

Params (the JAX pytree layout):
  embed:   [V, D]
  layers:  stacked {attn_norm, q_w, k_w, v_w, o_w, mlp_norm, gate_w, up_w, down_w}
           (or, in the trainer's forward, lists of per-layer leaves)
           (stored input-major [D_in, D_out]; the decode cooks them to
           [L, out, in], models/decode.py decode_layout_params)
  norm:    [D]
  lm_head: [D, V]

Under a model axis (`mesh`, parallel.make_mesh(model > 1)) the params are
this rank's slices (parallel.shard_params): q/k/v and gate/up
column-parallel, o and down row-parallel, embed and lm_head split on the
vocab. The forward then runs num_heads / tp and num_kv_heads / tp local
heads and gives this rank's [B, S, V/tp] logits; the collectives are
parallel/tensor_parallel.py's (the sums JAX's GSPMD inserts).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attend, causal_bias, padding_bias
from ..ops.norm import rms_norm
from ..parallel.tensor_parallel import copy_to_model, local_count, reduce_from_model, vocab_embed, vocab_token_logprob
from ..utils.constants import IGNORE_INDEX
from ..utils.profiling import count
from .config import LlamaConfig
from .param_tree import ParamTree, tree_from_leaves
from .vit import _normal


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


def local_heads(cfg: LlamaConfig, mesh=None) -> Tuple[int, int]:
    """(query heads, key/value heads) of one rank: num_heads / tp and
    num_kv_heads / tp; ValueError when tp does not divide both."""
    return (local_count(cfg.num_heads, mesh, "num_heads"),
            local_count(cfg.num_kv_heads, mesh, "num_kv_heads"))


def decoder_block(cfg: LlamaConfig, x: torch.Tensor, layers: Dict, li: int,
                  bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mesh=None) -> torch.Tensor:
    """One pre-norm decoder block on layer `li` of the stacked params (this
    rank's heads and intermediate slice under a model axis). SiLU runs in
    the model dtype (HF LlamaMLP), unlike the decode's f32 SiLU."""
    count("blocks.llm")
    b, s, _ = x.shape
    hd = cfg.head_dim
    h, hkv = local_heads(cfg, mesh)
    p = {name: t[li] for name, t in layers.items()}

    y = copy_to_model(rms_norm(x, p["attn_norm"], cfg.rms_eps), mesh)
    q = (y @ p["q_w"]).reshape(b, s, h, hd).transpose(1, 2)
    k = (y @ p["k_w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (y @ p["v_w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    attn = attend(q, k, v, bias, cfg.attn_impl).transpose(1, 2).reshape(b, s, h * hd)
    x = x + reduce_from_model(attn @ p["o_w"], mesh)

    y = copy_to_model(rms_norm(x, p["mlp_norm"], cfg.rms_eps), mesh)
    gate = F.silu(y @ p["gate_w"])
    return x + reduce_from_model((gate * (y @ p["up_w"])) @ p["down_w"], mesh)


def llama_apply(
    params: Dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits_tail: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """inputs_embeds [B, S, D] -> f32 logits [B, S, V], or [B, k, V] for the
    last k positions with `logits_tail=k` (this rank's [.., V/tp] under a
    model axis). `remat` recomputes each decoder block in the backward
    (torch.utils.checkpoint, non-reentrant; the recompute runs the block's
    collectives again, in the same order on every rank)."""
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
    for li in range(len(layers["q_w"])):  # a stack, or a list of per-layer leaves
        if remat:
            # no block draws random numbers, so no RNG state is stashed (a CUDA graph's capture refuses it)
            x = checkpoint(decoder_block, cfg, x, layers, li, bias, cos, sin, mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = decoder_block(cfg, x, layers, li, bias, cos, sin, mesh)
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    if logits_tail is not None:
        x = x[:, s - logits_tail :, :]
    return (copy_to_model(x, mesh) @ params["lm_head"]).float()


def check_shard(params: Dict, cfg, mesh) -> None:
    """ValueError unless the decoder params (Llama or Phi) hold this rank's
    slices: its query heads and vocab rows under a model axis, all of them
    without one (a whole tree given to a rank, or a slice to one process)."""
    tp = mesh.tp if mesh is not None else 1
    heads = local_count(cfg.num_heads, mesh, "num_heads") * cfg.head_dim
    got = (params["layers"]["q_w"][0].shape[-1], params["embed"].shape[0])
    if got != (heads, cfg.vocab_size // tp):
        raise ValueError(f"decoder params with q width {got[0]} and {got[1]} vocab rows; a rank of a model axis "
                         f"of {tp} takes {heads} and {cfg.vocab_size // tp}: cut them with parallel.shard_params")


def embed_tokens(params: Dict, input_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """The embedding rows of `input_ids` (from the vocab-split embed under a
    model axis)."""
    return vocab_embed(params["embed"], input_ids, mesh)


def ce_sums(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shifted CE's parts: logits[:, :-1] predict labels[:, 1:]; the
    NLL summed over the positions whose label is not IGNORE, and their
    count. Under a model axis `logits` is this rank's vocab slice and the
    log-softmax runs over the whole rows (parallel/tensor_parallel.py)."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    token_ll = vocab_token_logprob(shift_logits, safe, mesh)
    return -torch.where(valid, token_ll, torch.zeros_like(token_ll)).sum(), valid.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Shifted CE: mean over valid tokens, f32."""
    loss_sum, n_valid = ce_sums(logits, labels, mesh)
    return loss_sum / n_valid.clamp(min=1)


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
    return tree_from_leaves(iter_llama_params(gen, cfg, dtype, device))


def iter_llama_params(
    gen: torch.Generator, cfg: LlamaConfig, dtype=torch.float32,
    device: Optional[torch.device] = None,
):
    """(path, leaf) of init_llama_params, each leaf drawn only when the
    caller asks for it (so a caller can cut and drop one before the next is
    drawn); the draws and their order are init_llama_params'."""
    device = gen.device if device is None else device
    d, l, inter, v = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size, cfg.vocab_size
    hd, h, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    yield ("embed",), normal((v, d))
    layers = (
        ("attn_norm", lambda: ones((l, d))),
        ("q_w", lambda: normal((l, d, h * hd))),
        ("k_w", lambda: normal((l, d, hkv * hd))),
        ("v_w", lambda: normal((l, d, hkv * hd))),
        ("o_w", lambda: normal((l, h * hd, d))),
        ("mlp_norm", lambda: ones((l, d))),
        ("gate_w", lambda: normal((l, d, inter))),
        ("up_w", lambda: normal((l, d, inter))),
        ("down_w", lambda: normal((l, inter, d))),
    )
    for key, draw in layers:
        yield ("layers", key), draw()
    yield ("norm",), ones((d,))
    yield ("lm_head",), normal((d, v))
