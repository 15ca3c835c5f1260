"""The DeepSeek-V3 decoder (Moonlight-16B-A3B's), after the model's own
`modeling_deepseek.py` and the DeepSeek-V2/V3 papers, with `llama_apply`'s
signature: multi-head latent attention, a dense SwiGLU in the first layers
and sparse experts with shared experts in the rest.

With y = RMSNorm(x) before each half of a block:
  - MLA (no query compression): q = y W_q -> [B, S, H, nope + rope];
    [c, k_pe] = y W_kv_a; c = RMSNorm(c) (the latent, kv_lora_rank wide);
    [k_nope, v] = c W_kv_b -> [B, S, H, nope + value]. q's rope channels and
    k_pe (one key shared by every head) are taken from DeepSeek's
    interleaved channel order, rotated (`rotate_half`, rope_theta), and
    k = [k_nope, k_pe on every head]; attention with the causal + padding
    bias at scale (nope + rope)^-0.5, then W_o. `ops/attention.attend` runs
    its plain `mha` here: the value width differs from the query/key width.
  - Dense layers (the first `first_k_dense_replace`): (silu(y W_g) * y W_u) W_d.
  - Sparse-expert layers: s = sigmoid(y W_r) in float32; the
    `num_experts_per_tok` experts of the highest s + e_bias (the correction
    bias chooses, it does not weigh); w = s[idx] / (sum s[idx] + 1e-20) *
    routed_scaling_factor; out = sum_k w_k E_idx_k(y) + Shared(y), every
    expert and the shared experts a SwiGLU. The routed rows are sorted by
    expert and each projection is one grouped product of all experts
    (`ops/grouped_matmul.py`, offsets on the device: no host synchronize,
    no token dropped); the combine sums the k weighted outputs in float32,
    as the published code does. The expert indices carry no gradient; the
    gradient reaches y through the experts' inputs and the gate weights.

Params (input-major [D_in, D_out] like models/llama.py):
  embed:   [V, D]
  layers:  stacked over all L layers: attn_norm [L, D], q_w [L, D, H*(nope+rope)],
           kv_a_w [L, D, rank+rope], kv_norm [L, rank], kv_b_w [L, rank, H*(nope+value)],
           o_w [L, H*value, D], mlp_norm [L, D]
  dense:   the dense layers' gate_w, up_w [Ld, D, I], down_w [Ld, I, D]
  moe:     the expert layers' router_w [Lm, D, E], e_bias [Lm, E] (float32),
           gate_w, up_w [Lm, E, D, F], down_w [Lm, E, F, D],
           shared_gate_w, shared_up_w [Lm, D, Fs], shared_down_w [Lm, Fs, D]
  norm:    [D]
  lm_head: [D, V]

Only the attack's single-device forward and backward run this decoder. A
model axis, serving's decode (which has no latent cache) and the trainer
refuse it (`unsupported`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attend, causal_bias, padding_bias
from ..ops.grouped_matmul import grouped_matmul
from ..ops.norm import rms_norm
from ..parallel.tensor_parallel import split
from ..utils.profiling import count, keep, span
from .config import DeepseekV3Config
from .llama import apply_rope, rope_cos_sin
from .param_tree import ParamTree
from .vit import _normal


def unsupported(what: str) -> ValueError:
    """The error of a path that does not run the DeepSeek-V3 decoder."""
    return ValueError(f"{what} does not take the DeepSeek-V3 decoder (DeepseekV3Config: latent attention and "
                      "sparse experts); only the attack's single-device forward and backward run it")


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rotary channel order to rotate_half's: channels (0, 1),
    (2, 3), ... are pairs, laid out as [0, 2, 4, ..., 1, 3, 5, ...]
    (`view(..., d/2, 2).transpose(-1, -2)`)."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def mla(cfg: DeepseekV3Config, x: torch.Tensor, p: Dict, bias: torch.Tensor, cos: torch.Tensor,
        sin: torch.Tensor) -> torch.Tensor:
    """x plus the latent attention of one layer (`p`: that layer's
    `layers` leaves)."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    y = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    q = (y @ p["q_w"]).view(b, s, h, dn + dr).transpose(1, 2)
    c, k_pe = (y @ p["kv_a_w"]).split([cfg.kv_lora_rank, dr], dim=-1)
    kv = (rms_norm(c, p["kv_norm"], cfg.rms_eps) @ p["kv_b_w"]).view(b, s, h, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe, k_pe = apply_rope(deinterleave(q[..., dn:]), deinterleave(k_pe[:, None]), cos, sin)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, s, dr)], dim=-1)
    out = attend(q, k, v, bias)  # plain mha: scale (dn + dr)^-0.5, from q's width
    return x + out.transpose(1, 2).reshape(b, s, h * dv) @ p["o_w"]


def swiglu(y: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, down_w: torch.Tensor) -> torch.Tensor:
    """(silu(y W_g) * y W_u) W_d in the model dtype (HF DeepseekV3MLP)."""
    return (F.silu(y @ gate_w) * (y @ up_w)) @ down_w


def router_scores(y: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """[T, E] float32: the sigmoid of the float32 router logits."""
    return torch.sigmoid(y.float() @ router_w.float())


def choose_experts(cfg: DeepseekV3Config, scores: torch.Tensor, e_bias: torch.Tensor) -> torch.Tensor:
    """[T, k]: the experts of the k highest scores + e_bias (`noaux_tc` with
    one group: the group step keeps every expert)."""
    return torch.topk(scores.detach() + e_bias.float(), cfg.num_experts_per_tok, dim=-1).indices


def gate_weights(cfg: DeepseekV3Config, scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[T, k] float32: the chosen experts' unbiased scores, normalized to
    sum 1 and scaled by routed_scaling_factor."""
    w = scores.gather(-1, idx)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def routed_experts(y: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, p: Dict) -> torch.Tensor:
    """sum_k w[t, k] E_idx[t, k](y[t]) for y [T, D], in y's dtype: the T * k
    routed rows sorted by expert, each projection one grouped product over
    the experts, the outputs put back in (token, k) order and summed in
    float32. Keeps each expert's routed rows [E] int32 (`moe.expert_tokens`)
    while a profiler records."""
    t, k = idx.shape
    d = y.shape[-1]
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # slot t * k + j, by expert
    rows = torch.zeros(p["gate_w"].shape[0], dtype=torch.int32, device=y.device)
    rows.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    keep("moe.expert_tokens", rows)
    offs = rows.cumsum(0, dtype=torch.int32)
    # every token's k copies, then the permutation: the gradient sums each
    # token's k rows by a reduction, not by k atomic adds
    xs = y[:, None].expand(t, k, d).reshape(t * k, d).index_select(0, order)
    hidden = F.silu(grouped_matmul(xs, p["gate_w"], offs)) * grouped_matmul(xs, p["up_w"], offs)
    out = grouped_matmul(hidden, p["down_w"], offs)
    back = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=order.device))
    out = out.index_select(0, back).view(t, k, d)
    return (out.float() * w[..., None]).sum(dim=1).to(y.dtype)


def moe(cfg: DeepseekV3Config, y: torch.Tensor, p: Dict, routes: Dict[int, torch.Tensor], li: int) -> torch.Tensor:
    """The sparse-expert MLP of layer `li` on y [B, S, D] (`p`: its `moe`
    leaves). The layer's expert choice is made once and kept in `routes`:
    a recomputation in the backward takes it from there, so it routes
    exactly as the forward did (its weights are recomputed from the scores,
    for their gradient)."""
    b, s, d = y.shape
    flat = y.reshape(b * s, d)
    scores = router_scores(flat, p["router_w"])
    idx = routes.get(li)
    if idx is None:
        idx = routes[li] = choose_experts(cfg, scores, p["e_bias"])
    out = routed_experts(flat, idx, gate_weights(cfg, scores, idx), p).view(b, s, d)
    return out + swiglu(y, p["shared_gate_w"], p["shared_up_w"], p["shared_down_w"])


def decoder_block(cfg: DeepseekV3Config, x: torch.Tensor, params: Dict, li: int, bias: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, routes: Dict[int, torch.Tensor]) -> torch.Tensor:
    """One pre-norm block on layer `li`: latent attention, then the dense
    or the sparse-expert MLP (in a `moe` span)."""
    count("blocks.llm")
    p = {name: t[li] for name, t in params["layers"].items()}
    x = mla(cfg, x, p, bias, cos, sin)
    y = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    first = cfg.first_k_dense_replace
    if li < first:
        dense = {name: t[li] for name, t in params["dense"].items()}
        return x + swiglu(y, dense["gate_w"], dense["up_w"], dense["down_w"])
    with span("moe"):
        return x + moe(cfg, y, {name: t[li - first] for name, t in params["moe"].items()}, routes, li)


def deepseek_apply(
    params: Dict,
    cfg: DeepseekV3Config,
    inputs_embeds: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    remat: bool = False,
    logits_tail: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """inputs_embeds [B, S, D] -> f32 logits [B, S, V], or [B, k, V] for the
    last k positions with `logits_tail=k`. `remat` recomputes each block in
    the backward (torch.utils.checkpoint, non-reentrant), each sparse-expert
    layer with the forward's expert choice. ValueError under a model axis."""
    if split(mesh):
        raise unsupported("a model axis")
    b, s, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        positions = torch.arange(s, device=dev)
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    bias = causal_bias(s, s, device=dev)
    if attention_mask is not None:
        bias = bias + padding_bias(attention_mask)

    routes: Dict[int, torch.Tensor] = {}
    x = inputs_embeds
    for li in range(cfg.num_layers):
        if remat:
            # no block draws random numbers, so no RNG state is stashed (a CUDA graph's capture refuses it)
            x = checkpoint(decoder_block, cfg, x, params, li, bias, cos, sin, routes, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = decoder_block(cfg, x, params, li, bias, cos, sin, routes)
    x = rms_norm(x, params["norm"], cfg.rms_eps)
    if logits_tail is not None:
        x = x[:, s - logits_tail:, :]
    return (x @ params["lm_head"]).float()


def check_shard(params: Dict, cfg: DeepseekV3Config, mesh) -> None:
    """ValueError under a model axis, or unless the params hold the whole
    decoder (every query head and vocab row)."""
    if split(mesh):
        raise unsupported("a model axis")
    got = (params["layers"]["q_w"][0].shape[-1], params["embed"].shape[0])
    want = (cfg.num_heads * cfg.qk_head_dim, cfg.vocab_size)
    if got != want:
        raise ValueError(f"decoder params with q width {got[0]} and {got[1]} vocab rows; the DeepSeek-V3 "
                         f"decoder takes {want[0]} and {want[1]}")


class Deepseek(ParamTree):
    """The DeepSeek-V3 decoder's params under the names above."""

    def __init__(self, cfg: DeepseekV3Config, tree: Dict) -> None:
        super().__init__(tree)
        self.cfg = cfg


def iter_deepseek_params(gen: torch.Generator, cfg: DeepseekV3Config, dtype=torch.float32,
                         device: Optional[torch.device] = None):
    """(path, leaf) of random params (normal * 0.02, unit norms, a zero
    e_bias) drawn from `gen` on `device`, each leaf only when the caller
    asks for it. The expert stacks are drawn one layer at a time
    into the stack, so the float32 transient of a draw is one layer's
    experts, not the whole stack's."""
    device = gen.device if device is None else device
    d, n, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    h, rank, dn, dr, dv = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ld, lm, e = cfg.first_k_dense_replace, cfg.num_moe_layers, cfg.n_routed_experts
    inter, f, fs = cfg.intermediate_size, cfg.moe_intermediate_size, cfg.shared_intermediate_size

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def by_layer(shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _normal(gen, shape[1:], dtype, device)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    yield ("embed",), normal((v, d))
    leaves = (
        ("layers", "attn_norm", lambda: ones((n, d))),
        ("layers", "q_w", lambda: normal((n, d, h * (dn + dr)))),
        ("layers", "kv_a_w", lambda: normal((n, d, rank + dr))),
        ("layers", "kv_norm", lambda: ones((n, rank))),
        ("layers", "kv_b_w", lambda: normal((n, rank, h * (dn + dv)))),
        ("layers", "o_w", lambda: normal((n, h * dv, d))),
        ("layers", "mlp_norm", lambda: ones((n, d))),
        ("dense", "gate_w", lambda: normal((ld, d, inter))),
        ("dense", "up_w", lambda: normal((ld, d, inter))),
        ("dense", "down_w", lambda: normal((ld, inter, d))),
        ("moe", "router_w", lambda: normal((lm, d, e))),
        ("moe", "e_bias", lambda: torch.zeros((lm, e), dtype=torch.float32, device=device)),
        ("moe", "gate_w", lambda: by_layer((lm, e, d, f))),
        ("moe", "up_w", lambda: by_layer((lm, e, d, f))),
        ("moe", "down_w", lambda: by_layer((lm, e, f, d))),
        ("moe", "shared_gate_w", lambda: normal((lm, d, fs))),
        ("moe", "shared_up_w", lambda: normal((lm, d, fs))),
        ("moe", "shared_down_w", lambda: normal((lm, fs, d))),
    )
    for group, key, draw in leaves:
        yield (group, key), draw()
    yield ("norm",), ones((d,))
    yield ("lm_head",), normal((d, v))
