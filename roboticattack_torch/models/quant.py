"""Weight-only int8 / int4 quantization for the serving decode.

The same schemes, layouts and arithmetic as the JAX package's
`models/quant.py`, so the packed bytes and scales are identical:

int8: symmetric per-output-channel scales over the contraction dim;
dequantization is one f32 multiply after the matmul.

int4: symmetric scales per (channel, group of `group_size` contraction
channels), stored two s4 per int8 byte along the contraction axis (low
nibble = channel 2j, high nibble = 2j+1; pairs never straddle a group):
stacks [L, out, in/2] with f32 scales [L, out, in/gs]; lm_head [D/2, V] with
scales [V, D/gs].

Both modes: `embed` [V, D] becomes int8 with a per-row scale [V]. Vision,
projector and norms are untouched.

Quantization runs on whatever device the cooked params live on, one layer
of one stack at a time, so the f32 transients stay one layer's size.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

QUANT_LAYER_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
INT8_MAX = 127.0
INT4_MAX = 7.0
DEFAULT_GROUP_SIZE = 128  # the GPTQ/AWQ convention; divides 4096 and 11008


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack an even-last-dim int tensor of s4 values ([-8, 7]) two-per-byte:
    [..., n] -> int8 [..., n/2], low nibble = channel 2j, high = 2j+1. The
    bit operations run on int32 (no shifts of int8 tensors)."""
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def _quantize_last_dim(w: torch.Tensor):
    """Symmetric int8 over the last axis (the contraction dim in the cooked
    layout): returns (int8 tensor, f32 scale with the last axis reduced)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax / INT8_MAX, 1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def _quantize_grouped(w: torch.Tensor, group_size: int, what: str):
    """Symmetric int4 over groups of the last axis: returns (packed int8
    tensor [..., in/2], f32 scale [..., in/group_size])."""
    wf = w.float()
    contraction = wf.shape[-1]
    if contraction % group_size:
        raise ValueError(
            f"int4 group_size={group_size} must divide {what}'s contraction "
            f"dim ({contraction}); pass a divisor (e.g. 64)"
        )
    if group_size % 2:
        raise ValueError(
            f"int4 group_size={group_size} must be EVEN: values pack two per "
            f"byte within a group"
        )
    g = contraction // group_size
    wg = wf.reshape(wf.shape[:-1] + (g, group_size))
    absmax = wg.abs().amax(dim=-1)                              # [..., G]
    scale = torch.clamp_min(absmax / INT4_MAX, 1e-12)
    q = torch.clamp(torch.round(wg / scale[..., None]), -INT4_MAX, INT4_MAX)
    return _pack_nibbles(q.reshape(wf.shape).to(torch.int8)), scale


def int4_group_size_for(cfg, tp: int = 1) -> int:
    """Largest standard group size dividing every decode contraction dim of
    a VLAConfig (hidden, num_heads*head_dim, intermediate). 7B -> 128;
    vla-tiny -> 64.

    `tp` > 1: the group size also divides each rank's contraction of the
    row-parallel stacks (o_w: num_heads*head_dim/tp, down_w:
    intermediate/tp), so no group straddles a shard boundary. 7B tp=2 ->
    128, tp=4 -> 64 (11008/4 is not a multiple of 128); vla-tiny tp=2 ->
    32."""
    lcfg = cfg.llm
    row_parallel = (lcfg.num_heads * lcfg.head_dim, lcfg.intermediate_size)
    if tp > 1 and any(d % tp for d in row_parallel):
        raise ValueError(
            f"int4 decode TP: tp={tp} does not divide the row-parallel "
            f"contractions {row_parallel} of {cfg.name!r}; pick a tp that "
            f"divides both"
        )
    dims = (
        lcfg.hidden_size,
        lcfg.num_heads * lcfg.head_dim,
        lcfg.intermediate_size,
        (lcfg.num_heads * lcfg.head_dim) // tp,
        lcfg.intermediate_size // tp,
    )
    for gs in (128, 64, 32, 16, 8, 4, 2):
        # 2 is the floor: values pack two per byte within a group
        if all(d % gs == 0 for d in dims):
            return gs
    raise ValueError(
        f"int4 quantization needs an even group size dividing every decode "
        f"contraction dim of {cfg.name!r} ({dims}); an odd contraction dim "
        f"cannot pack two s4 values per byte"
    )


def quant_mode(params: Dict) -> Optional[str]:
    """'int8' / 'int4' if the LLM projection stacks are quantized, else
    None. Both modes store int8 bytes; the discriminator is the scale rank
    (grouped int4 scales keep the stack's rank, int8 scales drop one)."""
    layers = params["llm"]["layers"]
    qw = layers["q_w"]
    if qw.dtype != torch.int8:
        return None
    sc = layers.get("q_w_scale")
    if sc is not None and sc.dim() == qw.dim():
        return "int4"
    return "int8"


def is_quantized(params: Dict) -> bool:
    """True if the LLM projection stacks are int8/int4
    (quantize_decode_params output)."""
    return quant_mode(params) is not None


def quantize_matrix(w: torch.Tensor, mode: str, group_size: int, what: str):
    """One [out, in] matrix in the cooked layout -> (int8 [out, in] or
    packed int4 [out, in/2], f32 scale [out] or [out, in/group_size]): the
    per-layer step of quantize_decode_params."""
    if mode == "int8":
        return _quantize_last_dim(w)
    return _quantize_grouped(w, group_size, what)


def quantize_decode_params(
    params: Dict,
    mode: str = "int8",
    group_size: int = DEFAULT_GROUP_SIZE,
) -> Dict:
    """Quantize a COOKED decode pytree (decode_layout_params output).

    mode="int8": each projection stack `k` [L, out, in] becomes int8 plus
    `k + "_scale"` f32 [L, out]; `lm_head` [D, V] gets a per-column scale [V].
    mode="int4": packed int8 stacks [L, out, in/2] with grouped f32 scales
    [L, out, in/group_size]; `lm_head` becomes [D/2, V] with scales
    [V, D/group_size]. Both: `embed` int8 with a per-row scale [V].
    Returns a new dict spine; the input dicts are not modified."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"mode={mode!r}; supported: 'int8', 'int4'")
    llm = params["llm"]
    layers = llm["layers"]
    if "gate_w" not in layers:
        raise ValueError(
            "int8/int4 decode quantization supports Llama-family layer "
            "stacks (gate/up/down SwiGLU); this pytree has none"
        )
    gw = layers["gate_w"]
    have = quant_mode(params)
    if have is not None:
        if have == mode:
            return params  # idempotent
        raise ValueError(
            f"params are already {have}-quantized; re-quantizing to {mode} "
            "would compound rounding — quantize from the bf16 cooked pytree"
        )
    # gate_w is never square: cooked is [L, inter, hidden] with inter > hidden
    if gw.shape[-2] <= gw.shape[-1]:
        raise ValueError(
            f"quantize_decode_params expects the COOKED layout "
            f"(decode_layout_params output); gate_w has shape {tuple(gw.shape)} "
            f"which is the [L, hidden, intermediate] storage layout"
        )

    def q_one(w, what):
        return quantize_matrix(w, mode, group_size, what)

    def q_stack(w, what):
        # one layer at a time: the f32 transients stay one layer's size
        parts = [q_one(w[i], what) for i in range(w.shape[0])]
        return (torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]))

    new_layers = dict(layers)
    for k in QUANT_LAYER_KEYS:
        if k in layers:
            new_layers[k], new_layers[k + "_scale"] = q_stack(new_layers[k], k)
    new_llm = dict(llm)
    new_llm["layers"] = new_layers
    # lm_head [D, V]: contraction is dim 0 -> quantize the [V, D] transpose
    lm_q, lm_s = q_one(llm["lm_head"].transpose(0, 1), "lm_head")
    new_llm["lm_head"] = lm_q.transpose(0, 1).contiguous()
    new_llm["lm_head_scale"] = lm_s
    new_llm["embed"], new_llm["embed_scale"] = _quantize_last_dim(llm["embed"])
    out = dict(params)
    out["llm"] = new_llm
    return out
