"""Small configurations of both families for the CPU tests: the cells'
structure (two towers with register tokens and LayerScale, grouped-query
heads; one pre-norm CLIP tower and Phi's block) at widths a test can hold."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def tiny_mistral():
    cfg = copy.deepcopy(_load("vla-mistral-7b"))
    cfg["llm"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16, intermediate_size=128, sliding_window=200)
    d, s = cfg["vision"]["towers"]
    d.update(embed_dim=32, depth=3, num_heads=2, mlp_hidden=64, image_size=56)
    s.update(embed_dim=48, depth=3, num_heads=2, mlp_hidden=96, image_size=56)
    return cfg


def tiny_phi():
    cfg = copy.deepcopy(_load("phi-2-3b"))
    cfg["llm"].update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, head_dim=16,
                      intermediate_size=128)
    cfg["vision"]["towers"][0].update(embed_dim=32, depth=3, num_heads=2, mlp_hidden=64, image_size=56)
    return cfg
