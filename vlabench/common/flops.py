"""Model FLOPs from a configuration file's sizes: every matrix product's
2 * m * n * k, counted once per use.

`attack_inner_step` is one inner step of the patch attack: the forward, then
the gradient with respect to the input only (the weights are frozen), which
costs one more product of each linear layer's size and two more of each
attention product's. Per-block recomputation in the backward is not
counted: it is work the program chose, not work the step needs.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 tensor cores (data sheet)


def vit_flops(t: Dict) -> Tuple[float, float]:
    """(linear, attention) forward FLOPs of one image through a tower: the
    patch embedding and depth - 1 blocks over the patches and prefix
    tokens."""
    n = (t["image_size"] // t["patch_size"]) ** 2
    s = n + int(t["cls"]) + t["num_reg_tokens"]
    d, blocks = t["embed_dim"], t["depth"] - 1
    lin = n * 2 * t["patch_size"] ** 2 * 3 * d
    lin += blocks * s * 2 * (3 * d * d + d * d + 2 * d * t["mlp_hidden"])
    return float(lin), float(blocks * 2 * 2 * s * s * d)


def num_patches(cfg: Dict) -> int:
    t = cfg["vision"]["towers"][0]
    return (t["image_size"] // t["patch_size"]) ** 2


def decoder_flops(cfg: Dict, text_len: int) -> Tuple[float, float]:
    """(linear, attention) forward FLOPs of one sequence of num_patches +
    text_len positions through the decoder, with the head's logits over the
    text positions alone (the attack's objectives read only those)."""
    c = cfg["llm"]
    d, layers, ffn = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    h = c["num_attention_heads"]
    hd = c.get("head_dim", d // h)
    s = num_patches(cfg) + text_len
    if c["family"] == "phi":  # q, k, v, dense; fc1, fc2
        per_token = 4 * d * d + 2 * d * ffn
    else:  # q, o; k, v on the kv heads; gate, up, down
        per_token = 2 * d * h * hd + 2 * d * c["num_key_value_heads"] * hd + 3 * d * ffn
    lin = s * layers * 2 * per_token + text_len * 2 * d * c.get("padded_vocab_size", c["vocab_size"])
    return float(lin), float(layers * 2 * 2 * s * s * h * hd)


def projector_flops(cfg: Dict) -> float:
    vdim = sum(t["embed_dim"] for t in cfg["vision"]["towers"])
    d = cfg["llm"]["hidden_size"]
    if cfg["vision"]["projector"] == "fused-gelu-mlp":
        per_patch = vdim * 4 * vdim + 4 * vdim * d + d * d
    else:
        per_patch = vdim * d + d * d
    return float(num_patches(cfg) * 2 * per_patch)


def attack_inner_step(cfg: Dict, batch: int, text_len: int) -> float:
    """FLOPs of one inner step of the patch attack on `batch` rows."""
    lin, attn = decoder_flops(cfg, text_len)
    lin += projector_flops(cfg)
    for t in cfg["vision"]["towers"]:
        v_lin, v_attn = vit_flops(t)
        lin, attn = lin + v_lin, attn + v_attn
    return batch * (2 * lin + 3 * attn)
