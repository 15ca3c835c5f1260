"""Greedy action decoding with a KV cache — the `predict_action` primitive,
in PyTorch.

A port of the JAX package's `models/decode.py`: generate(max_new_tokens=7,
greedy) = one multimodal prefill + a decode tail, then de-tokenize
`vocab - id`, clip, bin-center lookup. Right-padded prompts are handled by
per-row true lengths.

The KV cache is allocated once at full size, [L, B, Hkv, total, hd], and
written in place (prefill rows at [:, :, :, :t0], step i at t0 + i). The
single-device serving options of the JAX package:
- `kv_cache='int8'`: int8 cache with per-(batch, head, position) f32
  scales; `'int4'`: packed s4 nibbles along hd ([..., hd/2] int8) with
  grouped K scales and per-position V scales. The prefill attends over the
  live full-precision K/V, so the first token is the unquantized one.
- `visual_tokens=k`: keep the k most salient patch tokens before the LLM.
- `act_quant='int8'` (w8a8): per-token int8 activations and an int8 x int8
  -> int32 product in the prefill's projections.
- `draft_tokens`: the tail as Jacobi fixed-point passes over all positions
  at once (one host sync a pass) instead of sequential steps.

With int4 weights and `int4_kernel=True`, the tail's seven projections per
layer (s=1 steps and the s=7 Jacobi pass alike) go through the CUDA
dequant-matmul kernel (ops/q4_matmul.py); the prefill (s > 8) dequantizes
each layer's weights and runs one dense matmul, and the lm_head stays plain
PyTorch.

`mesh` (parallel.mesh.ServingMesh): tensor- and data-parallel serving, one
process a rank. The params are this rank's shard
(parallel.sharding.shard_decode_params: Megatron column/row splits of the
cooked stacks, the lm_head split on the vocab) and the inputs its replica's
rows. Where JAX's GSPMD inserts the collectives, this decode calls them:
one all-reduce over the tensor-parallel group after each row-parallel
projection (o_w, down_w), on the widest accumulator the projection holds
before its cast (f32 for int8 weight-only, int32 for w8a8, so w8a8 under TP
equals one process bit for bit; the product's dtype for bf16, f32 and
int4), one all-gather of the vocab-split logits a token, and, on the Jacobi
tail, one MAX all-reduce over the world a pass, so every replica runs the
passes JAX's one program runs over the global batch. The int4 kernel runs on
each rank's local stacks, where JAX refuses its Pallas kernel under a model
axis (GSPMD has no partitioning rule for it): a rank's stack is a plain
local tensor here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import dataclasses
import types

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..ops.norm import rms_norm
from ..parallel.mesh import ServingMesh
from ..ops.q4_matmul import _unpack_nibbles, q4_matmul
from ..utils.action_tokenizer import decode_tokens
from ..utils.constants import ACTION_DIM, EMPTY_TOKEN_ID
from .config import DeepseekV3Config, PhiConfig, VLAConfig, torch_dtype
from .deepseek import unsupported
from .llama import apply_rope, rope_cos_sin
from .quant import _pack_nibbles
from .vlm import projector_apply, vision_features

# weight keys that decode_layout_params() pre-transposes ([in,out]->[out,in])
_COOKED_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
KV_CACHE_MODES = (None, "int8", "int4")


def _quantize_act(y, qmax: float = 127.0, amax_reduce=None):
    """Dynamic per-token symmetric int8 activation quantization: [b, s, in]
    -> (int8 same shape, f32 scale [b, s, 1]). Division by the scale and
    round-half-to-even, as the JAX package's `_quantize_act`.
    `amax_reduce` takes each token's absmax to its maximum over the
    tensor-parallel ranks (a row-parallel input holds a slice of the
    contraction), so every rank quantizes with one process's scale."""
    yf = y.float()
    absmax = yf.abs().amax(dim=-1, keepdim=True)
    if amax_reduce is not None:
        absmax = amax_reduce(absmax)
    sy = torch.clamp_min(absmax / qmax, 1e-12)
    q = torch.clamp(torch.round(yf / sy), -qmax, qmax)
    return q.to(torch.int8), sy


def _int8_matmul(yq, w):
    """int8 [b, s, in] x int8 [out, in] -> int32 [b, s, out], exact.
    `torch._int_mm` on CUDA takes m > 16 rows and in, out multiples of 8,
    with the weight operand column-major (`w.t()` of the contiguous stack);
    it raises on a shape outside that (the 7B prefill is inside it)."""
    b, s, k = yq.shape
    return torch._int_mm(yq.reshape(b * s, k), w.t()).reshape(b, s, w.shape[0])


def _proj(y, w, cooked: bool, scale=None, act8: bool = False, q4k: bool = False, tp=None):
    """y @ W for storage layout [in, out] (cooked=False) or the decode
    layout [out, in] (cooked=True). `scale` is present iff `w` is quantized.
    `tp` (a ServingMesh, row-parallel projections only): the partial
    products of this rank's slice of the contraction are summed over the
    tensor-parallel ranks on the accumulator noted below, before the cast:

    int8 — per-output-channel scale [out], applied after an f32 contraction.
    int8 + act8 (the w8a8 prefill) — the activations quantized per token
    (_quantize_act), an exact int8 x int8 -> int32 product, dequantized as
    (out * sy) * scale.
    int4 — packed s4 [out, in/2] with grouped scales [out, G] (scale rank ==
    stack rank). s <= 8 with q4k: the CUDA kernel (ops/q4_matmul.py). s <= 8
    without: the nibble halves dequantized to y.dtype, contracted against
    the even/odd activation channels. s > 8 (prefill): the same dequantized
    halves interleaved back to [out, in], one matmul. Summed over `tp` in
    y.dtype (f32 for int8 weight-only, int32 for w8a8)."""
    red = (lambda t: t) if tp is None else tp.tp_sum
    if scale is not None and scale.dim() == w.dim():  # grouped int4 (packed s4)
        if q4k and y.shape[1] <= 8:
            return red(q4_matmul(y, w, scale))
        out_dim, in_half = w.shape
        g = scale.shape[-1]
        lo, hi = _unpack_nibbles(w)
        sc = scale.float()[..., None]
        ld = (lo.float().reshape(out_dim, g, -1) * sc).to(y.dtype).reshape(out_dim, in_half)
        hd = (hi.float().reshape(out_dim, g, -1) * sc).to(y.dtype).reshape(out_dim, in_half)
        if y.shape[1] <= 8:
            return red(y[..., 0::2] @ ld.T + y[..., 1::2] @ hd.T)
        # interleaved after the cast, so the copy moves y.dtype elements
        return red(y @ torch.stack([ld, hd], dim=-1).reshape(out_dim, 2 * in_half).T)
    if scale is not None:  # per-output-channel int8
        if act8:
            yq, sy = _quantize_act(y, amax_reduce=None if tp is None else tp.tp_max)
            return ((red(_int8_matmul(yq, w)).float() * sy) * scale).to(y.dtype)
        out = red(torch.matmul(y.float(), w.float().T))
        return (out * scale).to(y.dtype)
    if cooked:
        return red(y @ w.T)
    return red(y @ w)


def _pj(p, key, y, cooked: bool, act8: bool = False, q4k: bool = False, tp=None):
    """Layer-dict projection: dispatches on the presence of the scale leaf.
    `tp`: the ServingMesh of a row-parallel projection (o_w, down_w)."""
    return _proj(y, p[key], cooked, p.get(key + "_scale"), act8, q4k, tp)


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


def _lm_logits(p_llm, h, tp=None):
    """[B, 1, D] hidden -> [B, V] f32 logits (single-position wrapper)."""
    return _gathered_logits(p_llm, h, tp)[:, 0]


def _gathered_logits(p_llm, h, tp=None):
    """_lm_logits_all, with a vocab-split lm_head (`tp`, a ServingMesh)
    gathered back to the whole [B, S, V] row over the tensor-parallel
    ranks: the argmax then sees the row one process sees."""
    logits = _lm_logits_all(p_llm, h)
    return logits if tp is None else tp.tp_gather_last(logits)


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


def _qkv(cfg, p, y, cooked=False, act8=False, q4k=False):
    b, s, _ = y.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _pj(p, "q_w", y, cooked, act8, q4k).reshape(b, s, h, hd).transpose(1, 2)
    k = _pj(p, "k_w", y, cooked, act8, q4k).reshape(b, s, hkv, hd).transpose(1, 2)
    v = _pj(p, "v_w", y, cooked, act8, q4k).reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def _attend(q, k, v, bias):
    """fp32 scores (operands upcast, no bf16 rounding of the scores), fp32
    softmax, probabilities cast to q.dtype before P·V."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * (q.shape[-1] ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _quantize_kv(x, qmax: float = 127.0):
    """Per-(batch, head, position) symmetric quantization over the head dim:
    [B, H, T, hd] -> (int8 same shape, f32 scale [B, H, T]). qmax=127 for the
    int8 cache; qmax=7 for the V side of the int4 cache (values in [-7, 7],
    packed by the caller)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / qmax, 1e-12)
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def _kv4_group_size(hd: int) -> int:
    """Group size for the K side of the int4 KV cache: 32 channels per scale
    on the 7B (hd=128 -> 4 groups), clamped to hd//2 on small heads."""
    gs = max(1, min(32, hd // 2))
    return gs if hd % gs == 0 else hd


def _quantize_k4(x, gs: int):
    """K side of kv_cache='int4': symmetric int4 with grouped scales along
    the head dim — [B, H, T, hd] -> (int8 values in [-7, 7], same shape; f32
    scale [B, H, T, hd/gs])."""
    b, h, t, hd = x.shape
    g = hd // gs
    xg = x.float().reshape(b, h, t, g, gs)
    scale = torch.clamp_min(xg.abs().amax(dim=-1) / 7.0, 1e-12)   # [B,H,T,G]
    q = torch.clamp(torch.round(xg / scale[..., None]), -7.0, 7.0)
    return q.reshape(b, h, t, hd).to(torch.int8), scale


def _unpack_s4(p):
    """Packed s4 int8 [..., hd/2] -> int32 [..., hd], channel 2j from the low
    nibble and 2j+1 from the high one (the models/quant.py convention)."""
    lo, hi = _unpack_nibbles(p)
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (2 * p.shape[-1],))


def _attend_kv8(q, k8, sk, v8, sv, bias):
    """Attention over an int8 KV cache with per-position scales, exact
    dequantization with no extra matmul: scores = (q @ k8^T) * sk, and sv
    folds into the probabilities before P·V (cast to q.dtype after)."""
    scores = torch.matmul(q.float(), k8.float().transpose(-1, -2))
    scores = scores * sk[:, :, None, :] * (q.shape[-1] ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * sv[:, :, None, :]).to(q.dtype)
    return torch.matmul(probs, v8.to(q.dtype))


def _attend_kv4(q, k4, sk, v4, sv, bias):
    """Attention over a packed int4 KV cache (k4, v4: [B, H, T, hd/2] int8).
    K (grouped scales [B, H, T, G]) is dequantized as f32 x scale and cast
    to q.dtype before the score product; V (per-position scales [B, H, T])
    folds sv into the probabilities, as _attend_kv8."""
    hd = q.shape[-1]
    g = sk.shape[-1]
    k = _unpack_s4(k4)
    kd = (k.float().reshape(k.shape[:-1] + (g, hd // g)) * sk[..., None]).reshape(k.shape).to(q.dtype)
    scores = torch.matmul(q.float(), kd.float().transpose(-1, -2))
    scores = scores * (hd ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * sv[:, :, None, :]).to(q.dtype)
    return torch.matmul(probs, _unpack_s4(v4).to(q.dtype))


def kv_cache_shapes(lcfg, b: int, total: int, mode: Optional[str], dtype) -> Dict:
    """(shape, dtype) of each tensor of the decode's KV cache: k and v in the
    model dtype, int8, or packed int4 ([..., hd/2] int8), plus the f32 scales
    sk, sv of the quantized modes."""
    if mode not in KV_CACHE_MODES:
        raise ValueError(f"kv_cache={mode!r}; supported: None, 'int8', 'int4'")
    lead = (lcfg.num_layers, b, lcfg.num_kv_heads, total)
    hd = lcfg.head_dim
    if mode is None:
        return {"k": (lead + (hd,), dtype), "v": (lead + (hd,), dtype)}
    if mode == "int8":
        return {"k": (lead + (hd,), torch.int8), "v": (lead + (hd,), torch.int8),
                "sk": (lead, torch.float32), "sv": (lead, torch.float32)}
    return {"k": (lead + (hd // 2,), torch.int8), "v": (lead + (hd // 2,), torch.int8),
            "sk": (lead + (hd // _kv4_group_size(hd),), torch.float32),
            "sv": (lead, torch.float32)}


class _KVCache:
    """The decode's KV cache, allocated once at full size (kv_cache_shapes)
    and written in place; `write` quantizes fresh rows per the mode and
    `attend` reads a layer through the matching attention."""

    def __init__(self, lcfg, b: int, total: int, mode: Optional[str], dtype, device):
        self.mode = mode
        self.gs = _kv4_group_size(lcfg.head_dim)
        shapes = kv_cache_shapes(lcfg, b, total, mode, dtype)
        t = {name: torch.zeros(shape, dtype=dt, device=device) for name, (shape, dt) in shapes.items()}
        self.k, self.v, self.sk, self.sv = t["k"], t["v"], t.get("sk"), t.get("sv")

    def write(self, li: int, at: int, k, v) -> None:
        """k, v [B, Hkv, s, hd] into slots at..at+s-1 of layer li."""
        sl = slice(at, at + k.shape[2])
        if self.mode == "int8":
            (k, sk), (v, sv) = _quantize_kv(k), _quantize_kv(v)
        elif self.mode == "int4":
            (k, sk), (v, sv) = _quantize_k4(k, self.gs), _quantize_kv(v, 7.0)
            k, v = _pack_nibbles(k), _pack_nibbles(v)
        if self.mode is not None:
            self.sk[li, :, :, sl] = sk
            self.sv[li, :, :, sl] = sv
        self.k[li, :, :, sl] = k
        self.v[li, :, :, sl] = v

    def attend(self, li: int, q, bias):
        if self.mode == "int8":
            return _attend_kv8(q, self.k[li], self.sk[li], self.v[li], self.sv[li], bias)
        if self.mode == "int4":
            return _attend_kv4(q, self.k[li], self.sk[li], self.v[li], self.sv[li], bias)
        return _attend(q, self.k[li], self.v[li], bias)


def _mlp(cfg, p, x, cooked=False, act8=False, q4k=False, tp=None):
    """SwiGLU with the SiLU applied in f32, then cast (the decode path's
    numerics, which differ from the training forward's model-dtype SiLU).
    `tp`: the ServingMesh that sums the row-parallel down_w."""
    y = rms_norm(x, p["mlp_norm"], cfg.rms_eps)
    gate = F.silu(_pj(p, "gate_w", y, cooked, act8, q4k).float()).to(x.dtype)
    return x + _pj(p, "down_w", gate * _pj(p, "up_w", y, cooked, act8, q4k), cooked, act8, q4k, tp)


def _cached_block(lcfg, p, x, li, cache: _KVCache, at: int, cos, sin, bias, cooked, q4k, tp=None):
    """One decoder layer of the tail over s new positions (an s=1 step or
    the s=n Jacobi pass): their K/V go into the cache at slots at..at+s-1,
    then the queries attend over the cache. Weight-only projections."""
    y = rms_norm(x, p["attn_norm"], lcfg.rms_eps)
    q, k, v = _qkv(lcfg, p, y, cooked, q4k=q4k)
    q, k = apply_rope(q, k, cos, sin)
    cache.write(li, at, k, v)
    attn = cache.attend(li, q, bias)
    x = x + _pj(p, "o_w", attn.transpose(1, 2).flatten(2), cooked, q4k=q4k, tp=tp)
    return _mlp(lcfg, p, x, cooked, q4k=q4k, tp=tp)


def _tp_layout(lcfg, layers, tp: int):
    """The rank's local Llama config under `tp`-way tensor parallelism
    (heads, kv heads and the intermediate split tp ways). Raises the JAX
    decode's ValueErrors from the sizes alone, before any collective: kv
    heads that tp does not divide, and an int4 group that would straddle a
    row-parallel shard."""
    if lcfg.num_kv_heads % tp or lcfg.num_heads % tp or lcfg.intermediate_size % tp:
        raise ValueError(
            f"decode TP needs num_kv_heads ({lcfg.num_kv_heads}), num_heads and intermediate_size "
            f"divisible by the 'model' axis size ({tp})"
        )
    full_in = {"o_w": lcfg.num_heads * lcfg.head_dim, "down_w": lcfg.intermediate_size}
    for k, in_dim in full_in.items():
        sc = layers.get(k + "_scale")
        if sc is not None and sc.dim() == 3:
            # packed s4: the stored last axis is the rank's contraction/2
            gs = 2 * layers[k].shape[-1] // sc.shape[-1]
            if (in_dim // tp) % gs:
                raise ValueError(
                    f"int4 decode TP: {k}'s contraction per rank "
                    f"({in_dim}/{tp}) is not a multiple of the "
                    f"quantization group size ({gs}); re-quantize "
                    f"with a group_size dividing {in_dim // tp} "
                    f"(models.quant.int4_group_size_for(cfg, tp))"
                )
    # a namespace, not dataclasses.replace: LlamaConfig.head_dim derives from
    # num_heads, and a rank's heads keep the whole model's head_dim
    local = dataclasses.asdict(lcfg)
    local.update(num_heads=lcfg.num_heads // tp, num_kv_heads=lcfg.num_kv_heads // tp,
                 intermediate_size=lcfg.intermediate_size // tp, head_dim=lcfg.head_dim)
    return types.SimpleNamespace(**local)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor   # [B, ACTION_DIM] int32 generated token ids
    actions: torch.Tensor  # [B, ACTION_DIM] f32 normalized continuous actions
    # [B, ACTION_DIM, V] f32 logits each generated token was the argmax of
    # (the sequential tail; None on the Jacobi tail)
    logits: Optional[torch.Tensor] = None
    # Jacobi verification passes the tail ran (None on the sequential tail);
    # 1 = the draft was accepted whole
    verify_passes: Optional[int] = None


def greedy_decode_actions(
    params: Dict,
    cfg: VLAConfig,
    input_ids: torch.Tensor,        # [B, S] right-padded prompt (ends with 29871 at true_len)
    attention_mask: torch.Tensor,   # [B, S]
    pixel_values: torch.Tensor,     # [B, 2, H, W, 3] normalized
    num_steps: int = ACTION_DIM,
    cooked_weights: bool = False,   # params went through decode_layout_params
    mesh=None,
    kv_cache: Optional[str] = None,  # None (model dtype), 'int8', or 'int4'
    draft_tokens: Optional[torch.Tensor] = None,  # [B, num_steps] Jacobi draft
    visual_tokens: Optional[int] = None,  # keep the top-k patch tokens
    act_quant: Optional[str] = None,  # 'int8': w8a8 prefill (int8 weights)
    int4_kernel: bool = False,      # CUDA int4 dequant-matmul decode tail
) -> DecodeResult:
    """Greedy multimodal generation of `num_steps` action tokens. Call under
    torch.inference_mode() (VLAPolicy does).

    `draft_tokens` [B, num_steps]: the tail runs as Jacobi verification
    passes: each pass pushes all num_steps draft positions through the stack
    at once, reads the greedy token at each, and feeds them back as the next
    draft. Position i is exact after i passes, so the loop stops when the
    draft did not change or after num_steps-1 passes; a correct draft
    verifies in one. Position 0 is the prefill argmax. The result is the
    fixed point of the pass's own greedy operator: the sequential tokens up
    to the s=1-vs-s=n accumulation order.

    `mesh` (a ServingMesh): `params` is this rank's shard of the cooked tree
    and the inputs are its replica's rows; every rank of the world calls
    this with the same options (see the module docstring). `logits` hold
    the whole vocabulary."""
    if isinstance(cfg.llm, PhiConfig):
        raise NotImplementedError(
            "predict_action targets the OpenVLA (Llama-family) stack; the "
            "Phi-2 zoo VLM is a forward/CE model, not an action policy"
        )
    if isinstance(cfg.llm, DeepseekV3Config):
        raise unsupported("the serving decode (it has no latent-attention cache)")
    if mesh is not None and not isinstance(mesh, ServingMesh):
        raise TypeError(f"mesh={mesh!r}: pass a parallel.ServingMesh (parallel.make_serving_mesh)")
    lcfg = cfg.llm
    dtype = torch_dtype(cfg)
    device = input_ids.device
    b, _ = input_ids.shape
    p_llm = params["llm"]
    layers = p_llm["layers"]
    tp = mesh if mesh is not None and mesh.tp > 1 else None
    if tp is not None:
        lcfg = _tp_layout(lcfg, layers, tp.tp)

    if layers["q_w"].dtype == torch.int8 and not cooked_weights:
        raise ValueError(
            "int8/int4-quantized params (quantize_decode_params output) are "
            "always in the cooked layout; pass cooked_weights=True"
        )
    if tp is not None and layers["q_w"].shape[-2 if cooked_weights else -1] != lcfg.num_heads * lcfg.head_dim:
        raise ValueError(
            f"q_w holds {layers['q_w'].shape[-2 if cooked_weights else -1]} output channels, not this "
            f"rank's {lcfg.num_heads * lcfg.head_dim}: pass the rank's shard "
            "(parallel.sharding.shard_decode_params)"
        )
    qsc = layers.get("q_w_scale")
    packed4 = qsc is not None and qsc.dim() == layers["q_w"].dim()
    if act_quant not in (None, "int8"):
        raise ValueError(f"act_quant={act_quant!r}; supported: None, 'int8'")
    act8 = act_quant == "int8"
    if act8 and (layers["q_w"].dtype != torch.int8 or packed4):
        raise ValueError(
            "act_quant='int8' (w8a8) needs per-channel int8 weights — run "
            "quantize_decode_params(mode='int8') first (int4's grouped scales "
            "have no int8 x int8 contraction form)"
        )
    if draft_tokens is not None:
        if tuple(draft_tokens.shape) != (b, num_steps):
            raise ValueError(
                f"draft_tokens shape {tuple(draft_tokens.shape)}; expected "
                f"{(b, num_steps)} (one draft token per decode position)"
            )
        # an id past the embedding is an out-of-bounds gather on the card (a
        # device-side assert that poisons the context); JAX's gather clamps.
        # A meta draft (the audit, parallel/evidence.py) has no ids to check.
        if not draft_tokens.is_meta and bool(((draft_tokens < 0) | (draft_tokens >= lcfg.vocab_size)).any()):
            raise ValueError(f"draft_tokens hold ids outside [0, {lcfg.vocab_size})")
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
    if visual_tokens is not None:
        nv = projected.shape[1]
        if not 1 <= visual_tokens <= nv:
            raise ValueError(
                f"visual_tokens={visual_tokens} must be in [1, {nv}] "
                f"(the model produces {nv} patch tokens)"
            )
        if visual_tokens < nv:
            # saliency = the f32 norm of each model-dtype projected token;
            # sorting the kept indices keeps raster order. torch.topk and
            # lax.top_k may order ties differently: the sort hides that
            # unless two saliencies tie across the k boundary.
            pf = projected.float()
            sal = (pf * pf).sum(dim=-1).sqrt()
            idx = torch.topk(sal, visual_tokens, dim=-1).indices.sort(dim=-1).values
            projected = torch.gather(projected, 1, idx[..., None].expand(-1, -1, projected.shape[-1]))
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
    cache = _KVCache(lcfg, b, total, kv_cache, mm_emb.dtype, device)

    # --- prefill: all blocks over the multimodal prefix, K/V into the cache.
    # It attends over the live full-precision K/V; quantization applies only
    # to what the tail re-reads. w8a8 quantizes these projections only.
    x = mm_emb
    for li in range(nl):
        p = _layer(layers, li)
        y = rms_norm(x, p["attn_norm"], lcfg.rms_eps)
        q, k, v = _qkv(lcfg, p, y, cooked_weights, act8)
        q, k = apply_rope(q, k, cos_all[:t0], sin_all[:t0])
        attn = _attend(q, k, v, prefix_bias)
        x = x + _pj(p, "o_w", attn.transpose(1, 2).flatten(2), cooked_weights, act8, tp=tp)
        x = _mlp(lcfg, p, x, cooked_weights, act8, tp=tp)
        cache.write(li, 0, k, v)
    hidden = rms_norm(x, p_llm["norm"], lcfg.rms_eps)
    last_hidden = hidden[torch.arange(b, device=device), last_idx][:, None]  # [B,1,D]
    logits = _lm_logits(p_llm, last_hidden, tp)
    token = torch.argmax(logits, dim=-1)

    slot_ids = torch.arange(total, device=device)
    prefix_valid = torch.cat(
        [mm_mask.bool(), torch.zeros((b, num_steps), dtype=torch.bool, device=device)], dim=1
    )  # [B, total] real prefix slots

    def run_layers(x, at, cos, sin, bias):
        for li in range(nl):
            x = _cached_block(lcfg, _layer(layers, li), x, li, cache, at, cos, sin, bias,
                              cooked_weights, q4k, tp)
        return rms_norm(x, p_llm["norm"], lcfg.rms_eps)

    # --- Jacobi verification tail
    if draft_tokens is not None:
        n = num_steps
        steps = torch.arange(n, device=device)
        d = torch.cat([token[:, None].to(torch.int32),
                       draft_tokens.to(device=device, dtype=torch.int32)[:, 1:]], dim=1)
        pos = num_patches + true_len[:, None] + steps[None, :]  # [B, n] rope positions
        cos_j, sin_j = cos_all[pos], sin_all[pos]                # [B, n, hd]
        # query i sees the prefix and the draft slots t0..t0+i
        draft_visible = (slot_ids[None, :] >= t0) & (slot_ids[None, :] <= t0 + steps[:, None])
        j_bias = torch.where(prefix_valid[:, None, :] | draft_visible[None], 0.0, NEG_INF)[:, None]
        passes = 0
        while passes < n - 1:
            h = run_layers(_embed_rows(p_llm, d, dtype), t0, cos_j, sin_j, j_bias)
            out = torch.argmax(_gathered_logits(p_llm, h, tp), dim=-1).to(torch.int32)
            # out[:, i] = the greedy token after d[:, :i+1]; position 0 stays
            # the prefill argmax
            new_d = torch.cat([d[:, :1], out[:, :-1]], dim=1)
            passes += 1
            # the pass's one host sync; on meta every pass runs, up to the
            # n - 1 bound, as JAX's while_loop program
            changed = True if new_d.is_meta else bool((new_d != d).any())
            if mesh is not None:  # any row of the global batch, as JAX's one program
                changed = mesh.any_rank(changed)
            d = new_d
            if not changed:
                break
        return _detokenize(cfg, d, verify_passes=passes)

    # --- cached decode steps
    tokens, step_logits = [token], [logits]
    for i in range(num_steps - 1):
        pos = num_patches + true_len + i                  # [B] rope position
        x = _embed_rows(p_llm, token, dtype)[:, None, :]  # [B, 1, D]
        cos, sin = cos_all[pos][:, None, :], sin_all[pos][:, None, :]
        decode_valid = (slot_ids >= t0) & (slot_ids <= t0 + i)
        bias = torch.where(prefix_valid | decode_valid[None], 0.0, NEG_INF)[:, None, None, :]
        logits = _lm_logits(p_llm, run_layers(x, t0 + i, cos, sin, bias), tp)
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
        step_logits.append(logits)
    tokens = torch.stack(tokens, dim=1).to(torch.int32)  # [B, num_steps]
    return _detokenize(cfg, tokens, logits=torch.stack(step_logits, dim=1))


def _detokenize(cfg, tokens, logits=None, verify_passes=None):
    """Tokens -> normalized actions: action vocab excludes the pad rows;
    clip + bin-center lookup."""
    return DecodeResult(tokens=tokens, actions=decode_tokens(tokens, cfg.action_vocab_size),
                        logits=logits, verify_passes=verify_passes)


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
