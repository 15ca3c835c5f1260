"""A configuration file as the program's own config object.

The program under test takes a `VLAConfig`; this builds it from the file's
sizes (the same sizes the reference reads), with the program's own
execution settings: the configuration's dtype, per-block recomputation in
the backward, and its chunked plain attention (the decoders of these
configurations have no hand-written attention kernel: grouped-query heads
and head_dim 80 are outside B1/B2).
"""

from __future__ import annotations

from typing import Dict

from roboticattack_torch.models.config import LlamaConfig, PhiConfig, ViTConfig, VLAConfig


def tower(t: Dict) -> ViTConfig:
    return ViTConfig(embed_dim=t["embed_dim"], depth=t["depth"], num_heads=t["num_heads"],
                     mlp_hidden=t["mlp_hidden"], patch_size=t["patch_size"], image_size=t["image_size"],
                     num_reg_tokens=t["num_reg_tokens"], use_cls_token=t["cls"], use_layerscale=t["layerscale"],
                     ln_eps=t["ln_eps"], pre_norm=t["pre_norm"], use_quick_gelu=t["quick_gelu"])


def vla_config(cfg: Dict) -> VLAConfig:
    c = cfg["llm"]
    if c["family"] == "phi":
        llm = PhiConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
                        num_heads=c["num_attention_heads"], intermediate_size=c["intermediate_size"],
                        partial_rotary_factor=c["partial_rotary_factor"], rope_theta=c["rope_theta"],
                        ln_eps=c["layer_norm_eps"], attn_impl="chunked")
    else:
        llm = LlamaConfig(vocab_size=c.get("padded_vocab_size", c["vocab_size"]), hidden_size=c["hidden_size"],
                          num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                          num_kv_heads=c["num_key_value_heads"], intermediate_size=c["intermediate_size"],
                          rope_theta=c["rope_theta"], rms_eps=c["rms_norm_eps"], attn_impl="chunked")
    towers = [tower(t) for t in cfg["vision"]["towers"]]
    return VLAConfig(name=cfg["name"], dino=towers[0], siglip=towers[1] if len(towers) > 1 else None,
                     llm=llm, dtype=cfg["dtype"], remat=True)
