"""Greedy action decoding with a KV cache — the `predict_action` primitive,
in PyTorch.

A port of the JAX package's `models/decode.py` sequential tail:
generate(max_new_tokens=7, greedy) = one multimodal prefill + 6 cached decode
steps, then de-tokenize `vocab - id`, clip, bin-center lookup. Right-padded
prompts are handled by per-row true lengths.

The KV cache is allocated once at full size, [L, B, Hkv, total, hd], and
written in place (prefill rows at [:, :, :, :t0], step i at t0 + i).

With int4 weights and `int4_kernel=True`, the decode tail's seven
projections per layer go through the CUDA dequant-matmul kernel
(ops/q4_matmul.py); the prefill (s > 8) dequantizes each layer's weights and
runs one dense matmul, and the lm_head stays plain PyTorch.

Not ported yet, each raising NotImplementedError with its ROADMAP.md item:
`mesh` (tensor/data parallel), `kv_cache='int8'|'int4'`, `draft_tokens`
(Jacobi), `visual_tokens`, `act_quant` (w8a8).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import not_ported
from ..ops.attention import NEG_INF
from ..ops.q4_matmul import _unpack_nibbles, q4_matmul
from ..utils.action_tokenizer import decode_tokens
from ..utils.constants import ACTION_DIM, EMPTY_TOKEN_ID
from .config import PhiConfig, VLAConfig, torch_dtype
from .llama import apply_rope, rms_norm, rope_cos_sin
from .vlm import projector_apply, vision_features

# weight keys that decode_layout_params() pre-transposes ([in,out]->[out,in])
_COOKED_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def _proj(y, w, cooked: bool, scale=None, q4k: bool = False):
    """y @ W for storage layout [in, out] (cooked=False) or the decode
    layout [out, in] (cooked=True). `scale` is present iff `w` is quantized:

    int8 — per-output-channel scale [out], applied after an f32 contraction.
    int4 — packed s4 [out, in/2] with grouped scales [out, G] (scale rank ==
    stack rank). s <= 8 with q4k: the CUDA kernel (ops/q4_matmul.py). s <= 8
    without: the nibble halves dequantized to y.dtype, contracted against
    the even/odd activation channels. s > 8 (prefill): the same dequantized
    halves interleaved back to [out, in], one matmul."""
    if scale is not None and scale.dim() == w.dim():  # grouped int4 (packed s4)
        if q4k and y.shape[1] <= 8:
            return q4_matmul(y, w, scale)
        out_dim, in_half = w.shape
        g = scale.shape[-1]
        lo, hi = _unpack_nibbles(w)
        sc = scale.float()[..., None]
        ld = (lo.float().reshape(out_dim, g, -1) * sc).to(y.dtype).reshape(out_dim, in_half)
        hd = (hi.float().reshape(out_dim, g, -1) * sc).to(y.dtype).reshape(out_dim, in_half)
        if y.shape[1] <= 8:
            return y[..., 0::2] @ ld.T + y[..., 1::2] @ hd.T
        # interleaved after the cast, so the copy moves y.dtype elements
        return y @ torch.stack([ld, hd], dim=-1).reshape(out_dim, 2 * in_half).T
    if scale is not None:  # per-output-channel int8
        out = torch.matmul(y.float(), w.float().T)
        return (out * scale).to(y.dtype)
    if cooked:
        return y @ w.T
    return y @ w


def _pj(p, key, y, cooked: bool, q4k: bool = False):
    """Layer-dict projection: dispatches on the presence of the scale leaf."""
    return _proj(y, p[key], cooked, p.get(key + "_scale"), q4k)


def _embed_rows(p_llm, ids, dtype):
    """Token-embedding lookup; per-row int8 dequantization is exact."""
    ids = ids.long()
    e = p_llm["embed"][ids]
    sc = p_llm.get("embed_scale")
    if sc is not None:
        return (e.float() * sc[ids][..., None]).to(dtype)
    return e


def _lm_logits_all(p_llm, h):
    """[B, S, D] hidden -> [B, S, V] f32 logits via the (possibly int8/int4)
    lm_head [D, V]. Quantized heads contract in f32 (operands upcast): f32
    logits from bf16 operands, as the JAX package's preferred_element_type."""
    w = p_llm["lm_head"]
    sc = p_llm.get("lm_head_scale")
    if sc is None:
        return (h @ w).float()
    if sc.dim() == 2:  # grouped int4: w is [D/2, V] packed, sc [V, G]
        d_half, v = w.shape
        g = sc.shape[-1]
        lo, hi = _unpack_nibbles(w)
        sct = sc.float().T[:, None, :]                       # [G, 1, V]
        ld = (lo.float().reshape(g, d_half // g, v) * sct).to(h.dtype)
        hd = (hi.float().reshape(g, d_half // g, v) * sct).to(h.dtype)
        he, ho = h[..., 0::2].float(), h[..., 1::2].float()  # [B, S, D/2]
        return he @ ld.float().reshape(d_half, v) + ho @ hd.float().reshape(d_half, v)
    return torch.matmul(h.float(), w.float()) * sc


def _lm_logits(p_llm, h):
    """[B, 1, D] hidden -> [B, V] f32 logits (single-position wrapper)."""
    return _lm_logits_all(p_llm, h)[:, 0]


def decode_layout_params(params: Dict) -> Dict:
    """Pre-transpose the stacked LLM projection weights to the [L, out, in]
    layout the decode matvecs want (a new dict spine; the transposed stacks
    are contiguous copies)."""
    from .quant import quant_mode

    if quant_mode(params) is not None:
        raise ValueError(
            "params are already int8/int4-quantized (quantize_decode_params "
            "output, which implies the cooked layout); cooking again would "
            "transpose the quantized stacks away from their scales"
        )
    llm = dict(params["llm"])
    layers = dict(llm["layers"])
    for k in _COOKED_KEYS:
        if k in layers:
            layers[k] = layers[k].transpose(1, 2).contiguous()
    llm["layers"] = layers
    out = dict(params)
    out["llm"] = llm
    return out


def _layer(layers: Dict, li: int) -> Dict:
    """Layer `li` of the stacked layer params (views, no copies)."""
    return {k: v[li] for k, v in layers.items()}


def _qkv(cfg, p, y, cooked=False, q4k=False):
    b, s, _ = y.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _pj(p, "q_w", y, cooked, q4k).reshape(b, s, h, hd).transpose(1, 2)
    k = _pj(p, "k_w", y, cooked, q4k).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _pj(p, "v_w", y, cooked, q4k).reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def _attend(q, k, v, bias):
    """fp32 scores (operands upcast, no bf16 rounding of the scores), fp32
    softmax, probabilities cast to q.dtype before P·V."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (q.shape[-1] ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _mlp(cfg, p, x, cooked=False, q4k=False):
    """SwiGLU with the SiLU applied in f32, then cast (the decode path's
    numerics, which differ from the training forward's model-dtype SiLU)."""
    y = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    gate = F.silu(_pj(p, "gate_w", y, cooked, q4k).float()).to(x.dtype)
    return x + _pj(p, "down_w", gate * _pj(p, "up_w", y, cooked, q4k), cooked, q4k)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor   # [B, ACTION_DIM] int32 generated token ids
    actions: torch.Tensor  # [B, ACTION_DIM] f32 normalized continuous actions
    # [B, ACTION_DIM, V] f32 logits each generated token was the argmax of
    logits: Optional[torch.Tensor] = None


def greedy_decode_actions(
    params: Dict,
    cfg: VLAConfig,
    input_ids: torch.Tensor,        # [B, S] right-padded prompt (ends with 29871 at true_len)
    attention_mask: torch.Tensor,   # [B, S]
    pixel_values: torch.Tensor,     # [B, 2, H, W, 3] normalized
    num_steps: int = ACTION_DIM,
    cooked_weights: bool = False,   # params went through decode_layout_params
    mesh=None,
    kv_cache: Optional[str] = None,
    draft_tokens: Optional[torch.Tensor] = None,
    visual_tokens: Optional[int] = None,
    act_quant: Optional[str] = None,
    int4_kernel: bool = False,      # CUDA int4 dequant-matmul decode tail
) -> DecodeResult:
    """Greedy multimodal generation of `num_steps` action tokens (the
    sequential tail, KV cache in the model dtype). Call under
    torch.inference_mode() (VLAPolicy does)."""
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError(
            "predict_action targets the OpenVLA (Llama-family) stack; the "
            "Phi-2 zoo VLM is a forward/CE model, not an action policy"
        )
    if mesh is not None:
        raise not_ported("tensor/data-parallel decode (mesh)", "slice 3: TP and DP")
    if kv_cache is not None:
        raise not_ported(f"kv_cache={kv_cache!r}", "slice 3: KV cache int8/int4")
    if draft_tokens is not None:
        raise not_ported("Jacobi draft_tokens", "slice 3: Jacobi drafts")
    if visual_tokens is not None:
        raise not_ported("visual_tokens pruning", "slice 3: visual tokens")
    if act_quant is not None:
        raise not_ported(f"act_quant={act_quant!r} (w8a8)", "slice 3: w8a8")

    lcfg = cfg.llm
    dtype = torch_dtype(cfg)
    device = input_ids.device
    b, _ = input_ids.shape
    p_llm = params["llm"]
    layers = p_llm["layers"]

    if layers["q_w"].dtype == torch.int8 and not cooked_weights:
        raise ValueError(
            "int8/int4-quantized params (quantize_decode_params output) are "
            "always in the cooked layout; pass cooked_weights=True"
        )
    qsc = layers.get("q_w_scale")
    packed4 = qsc is not None and qsc.dim() == layers["q_w"].dim()
    q4k = bool(int4_kernel) and packed4
    gw = tuple(layers["gate_w"].shape[-2:])
    want = (
        (lcfg.intermediate_size, lcfg.hidden_size // (2 if packed4 else 1))
        if cooked_weights
        else (lcfg.hidden_size, lcfg.intermediate_size)
    )
    if gw != want:
        raise ValueError(
            f"cooked_weights={cooked_weights} but gate_w has layout {gw}, "
            f"expected {want} — the params "
            f"{'were not' if cooked_weights else 'were already'} run through "
            "decode_layout_params (or were cooked twice)"
        )

    patches = vision_features(params["vision"], cfg, pixel_values)
    projected = projector_apply(params["projector"], patches).to(dtype)
    emb = _embed_rows(p_llm, input_ids, dtype)
    mm_emb = torch.cat([emb[:, :1], projected, emb[:, 1:]], dim=1)  # [B, T0, D]
    t0 = mm_emb.shape[1]
    num_patches = projected.shape[1]
    true_len = attention_mask.sum(dim=1)                 # text tokens per row
    last_idx = num_patches + true_len - 1                # last real prefix slot

    ones = torch.ones((b, num_patches), dtype=attention_mask.dtype, device=device)
    mm_mask = torch.cat([attention_mask[:, :1], ones, attention_mask[:, 1:]], dim=1)

    total = t0 + num_steps
    cos_all, sin_all = rope_cos_sin(torch.arange(total, device=device), lcfg.head_dim, lcfg.rope_theta)

    causal = torch.ones((t0, t0), dtype=torch.bool, device=device).tril()
    prefix_bias = torch.where(
        causal[None, None] & mm_mask[:, None, None, :].bool(), 0.0, NEG_INF
    )

    nl = lcfg.num_layers
    cache_k = torch.zeros(
        (nl, b, lcfg.num_kv_heads, total, lcfg.head_dim), dtype=mm_emb.dtype, device=device
    )
    cache_v = torch.zeros_like(cache_k)

    # --- prefill: all blocks over the multimodal prefix, K/V into the cache
    x = mm_emb
    for li in range(nl):
        p = _layer(layers, li)
        y = rms_norm(x, p["attn_norm"], lcfg.rms_eps)
        q, k, v = _qkv(lcfg, p, y, cooked_weights)
        q, k = apply_rope(q, k, cos_all[:t0], sin_all[:t0])
        attn = _attend(q, k, v, prefix_bias)
        x = x + _pj(p, "o_w", attn.transpose(1, 2).reshape(x.shape), cooked_weights)
        x = _mlp(lcfg, p, x, cooked_weights)
        cache_k[li, :, :, :t0] = k
        cache_v[li, :, :, :t0] = v
    hidden = rms_norm(x, p_llm["norm"], lcfg.rms_eps)
    last_hidden = hidden[torch.arange(b, device=device), last_idx][:, None]  # [B,1,D]
    logits = _lm_logits(p_llm, last_hidden)
    token = torch.argmax(logits, dim=-1)

    # --- cached decode steps
    slot_ids = torch.arange(total, device=device)
    prefix_valid = torch.cat(
        [mm_mask.bool(), torch.zeros((b, num_steps), dtype=torch.bool, device=device)], dim=1
    )  # [B, total] real prefix slots
    tokens, step_logits = [token], [logits]
    for i in range(num_steps - 1):
        pos = num_patches + true_len + i                  # [B] rope position
        x = _embed_rows(p_llm, token, dtype)[:, None, :]  # [B, 1, D]
        cos, sin = cos_all[pos][:, None, :], sin_all[pos][:, None, :]
        decode_valid = (slot_ids >= t0) & (slot_ids <= t0 + i)
        bias = torch.where(prefix_valid | decode_valid[None], 0.0, NEG_INF)[:, None, None, :]
        for li in range(nl):
            p = _layer(layers, li)
            y = rms_norm(x, p["attn_norm"], lcfg.rms_eps)
            q, k, v = _qkv(lcfg, p, y, cooked_weights, q4k)
            q, k = apply_rope(q, k, cos, sin)
            cache_k[li, :, :, t0 + i] = k[:, :, 0]
            cache_v[li, :, :, t0 + i] = v[:, :, 0]
            attn = _attend(q, cache_k[li], cache_v[li], bias)
            x = x + _pj(p, "o_w", attn.transpose(1, 2).reshape(x.shape), cooked_weights, q4k)
            x = _mlp(lcfg, p, x, cooked_weights, q4k)
        h = rms_norm(x, p_llm["norm"], lcfg.rms_eps)
        logits = _lm_logits(p_llm, h)
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
        step_logits.append(logits)
    tokens = torch.stack(tokens, dim=1).to(torch.int32)  # [B, num_steps]
    return _detokenize(cfg, tokens, logits=torch.stack(step_logits, dim=1))


def _detokenize(cfg, tokens, logits=None):
    """Tokens -> normalized actions: action vocab excludes the pad rows;
    clip + bin-center lookup."""
    return DecodeResult(tokens=tokens, actions=decode_tokens(tokens, cfg.action_vocab_size),
                        logits=logits)


def ensure_trailing_empty_token(
    input_ids: np.ndarray, attention_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: append 29871 after 'Out:' if missing, per row, preserving
    right padding."""
    ids = np.array(input_ids)
    mask = np.array(attention_mask)
    out_ids, out_mask = [], []
    for row_ids, row_mask in zip(ids, mask):
        n = int(row_mask.sum())
        if n == 0 or row_ids[n - 1] != EMPTY_TOKEN_ID:
            row_ids = np.concatenate([row_ids[:n], [EMPTY_TOKEN_ID], row_ids[n:]])[: len(row_ids) + 1]
            row_mask = np.concatenate([row_mask[:n], [1], row_mask[n:]])[: len(row_mask) + 1]
        out_ids.append(row_ids)
        out_mask.append(row_mask)
    width = max(len(r) for r in out_ids)
    out_ids = [np.pad(r, (0, width - len(r)), constant_values=32000) for r in out_ids]
    out_mask = [np.pad(r, (0, width - len(r))) for r in out_mask]
    return np.stack(out_ids).astype(np.int32), np.stack(out_mask).astype(np.int32)


def unnormalize_actions(actions: np.ndarray, norm_stats: Dict, unnorm_key: Optional[str] = None) -> np.ndarray:
    """q01/q99 unnormalization with mask."""
    if unnorm_key is None:
        if len(norm_stats) != 1:
            raise ValueError(f"pass unnorm_key; options: {list(norm_stats)}")
        unnorm_key = next(iter(norm_stats))
    st = norm_stats[unnorm_key]["action"]
    q01 = np.asarray(st["q01"], np.float64)
    q99 = np.asarray(st["q99"], np.float64)
    mask = np.asarray(st.get("mask", np.ones_like(q01, bool)))
    return np.where(mask, 0.5 * (actions + 1.0) * (q99 - q01) + q01, actions)
