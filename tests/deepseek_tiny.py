"""A Moonlight-shaped VLA small enough for the CPU tests: the benchmark's
configuration file (vlabench/configs/vla-moonlight-16b-a3b.json) with 3
decoder layers (one dense, two with sparse experts), 4 heads of nope 16 /
rope 8 / value 16 over a latent of 32, 8 routed experts of which each token
reads 2 beside 2 shared ones, routed_scaling_factor 2.446 as published, and
the two towers of the benchmark's small configurations."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vlabench", "configs", "vla-moonlight-16b-a3b.json")


def tiny_moonlight(dtype: str = "float32") -> dict:
    with open(CONFIG) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
               moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2, vocab_size=32064,
               dtype=dtype)
    dino, siglip = cfg["vision"]["towers"]
    dino.update(embed_dim=32, depth=3, num_heads=2, mlp_hidden=64, image_size=56)
    siglip.update(embed_dim=48, depth=3, num_heads=2, mlp_hidden=96, image_size=56)
    return cfg


def e_bias(params: dict, seed: int = 7, scale: float = 0.3) -> None:
    """A nonzero correction bias in every sparse-expert layer (in place)."""
    import torch

    moe = params["llm"]["moe"]
    moe["e_bias"] = scale * torch.randn(moe["e_bias"].shape, generator=torch.Generator().manual_seed(seed))
