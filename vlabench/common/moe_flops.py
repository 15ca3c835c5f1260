"""Model FLOPs of a sparse-expert configuration (the DeepSeek-V3 block,
its keys at the top level), and the bound of its routed experts' grouped
products, from the configuration file's sizes.

`attack_inner_step` counts as `flops.attack_inner_step` does (every matrix
product's 2 * m * n * k once per use; the forward, then the input gradient:
one more product of each linear layer's size and two more of each
attention product's; recomputation not counted), with the work a token
does: its `num_experts_per_tok` routed experts, the shared experts and the
router, not all the experts. The latent attention's query/key products
are `qk_nope + qk_rope` wide and its value products `v_head_dim`.

`routed_expert_bound_s` is the least time the routed experts' grouped
products of one inner step can take on the card: each product reads every
expert's matrix once (every expert receives tokens at these batch sizes)
and its routed rows in and out once, and performs 2 * rows * n * k FLOPs;
each product's bound is the larger of its bytes at the card's bandwidth
and its FLOPs at the dense bf16 peak. An inner step runs each of the three
projections (gate, up, down) three times in each sparse-expert layer: the
forward, the recomputation in the backward, and the input gradient (one
product of the same size per projection).
"""

from __future__ import annotations

from typing import Dict, Tuple

from vlabench.common import flops

PEAK_BF16_FLOPS = flops.PEAK_BF16_FLOPS
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (data sheet)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def decoder_flops(cfg: Dict, text_len: int) -> Tuple[float, float]:
    """(linear, attention) forward FLOPs of one sequence of num_patches +
    text_len positions through the decoder, with the head's logits over the
    text positions alone."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv, rank = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    f = cfg["moe_intermediate_size"]
    s = flops.num_patches(cfg) + text_len
    attention_proj = d * h * (dn + dr) + d * (rank + dr) + rank * h * (dn + dv) + h * dv * d
    dense_mlp = 3 * d * cfg["intermediate_size"]
    sparse_mlp = d * cfg["n_routed_experts"] + 3 * d * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    per_token = layers * attention_proj + dense * dense_mlp + (layers - dense) * sparse_mlp
    lin = s * 2 * per_token + text_len * 2 * d * cfg["vocab_size"]
    return float(lin), float(layers * 2 * s * s * h * (dn + dr + dv))


def attack_inner_step(cfg: Dict, batch: int, text_len: int) -> float:
    """FLOPs of one inner step of the patch attack on `batch` rows."""
    lin, attn = decoder_flops(cfg, text_len)
    lin += flops.projector_flops({"vision": cfg["vision"], "llm": {"hidden_size": cfg["hidden_size"]}})
    for t in cfg["vision"]["towers"]:
        v_lin, v_attn = flops.vit_flops(t)
        lin, attn = lin + v_lin, attn + v_attn
    return batch * (2 * lin + 3 * attn)


def routed_expert_products(cfg: Dict, batch: int, text_len: int) -> Tuple[int, float, float]:
    """(products, FLOPs, bytes) of one grouped product of the routed
    experts in one inner step, and how many such products the step runs."""
    rows = batch * (flops.num_patches(cfg) + text_len) * cfg["num_experts_per_tok"]
    d, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    size = DTYPE_BYTES[cfg["dtype"]]
    products = 3 * 3 * (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"])
    return products, 2.0 * rows * d * f, float(size * (e * d * f + rows * (d + f)))


def routed_expert_bound_s(cfg: Dict, batch: int, text_len: int) -> float:
    """The routed experts' grouped products of one inner step at their
    bound, in seconds."""
    products, flop, nbytes = routed_expert_products(cfg, batch, text_len)
    return products * max(flop / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
