"""A sparse-expert configuration file (the DeepSeek-V3 block, its keys at
the top level as the model's config.json has them) as the program's own
config object: the same sizes the reference reads, the configuration's
dtype and per-block recomputation in the backward, as `program.py` gives
the dense configurations. Variants the program's decoder does not
implement are refused rather than ignored (`reference/moe.py`'s table,
which the reference holds to as well)."""

from __future__ import annotations

from typing import Dict

from roboticattack_torch.models.config import DeepseekV3Config, VLAConfig

from vlabench.common.program import tower
from vlabench.reference.moe import check_implemented


def vla_config(cfg: Dict) -> VLAConfig:
    check_implemented(cfg)
    llm = DeepseekV3Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"], n_routed_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"], routed_scaling_factor=cfg["routed_scaling_factor"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"])
    towers = [tower(t) for t in cfg["vision"]["towers"]]
    return VLAConfig(name=cfg["name"], dino=towers[0], siglip=towers[1] if len(towers) > 1 else None,
                     llm=llm, dtype=cfg["dtype"], remat=True)
