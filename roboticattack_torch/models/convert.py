"""HF OpenVLA checkpoint -> the port's parameter tree.

Maps the `openvla/openvla-7b*` safetensors layout (torch [out, in] linear
weights, timm ViT names, HF Llama names) onto the stacked-layer,
input-major tree of the JAX package's `models/convert.py`, leaf for leaf
and bit for bit. LayerScale weights are read under `scale_factor` or under
`gamma` (the name the reference renames, modeling_prismatic.py:52-59).

Every function takes a raw state {HF name: tensor} and a `device`: each raw
tensor is moved there as it is read, and the transposes and stacks run
there, so the 7B's ~15 GB never sit on the host twice. A missing tensor
raises KeyError with its name.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .config import LlamaConfig, PhiConfig, ViTConfig, VLAConfig
from .param_tree import tree_from_leaves, tree_leaves
from .safetensors_io import checkpoint_shard_files, read_state_dict

__all__ = [
    "cast_tree", "checkpoint_shard_files", "convert_llama", "convert_projector", "convert_state_dict",
    "convert_vit", "iter_checkpoint_leaves", "load_checkpoint_dir", "load_norm_stats", "read_state_dict",
    "resample_pos_embed",
]


def getter(state: Mapping[str, torch.Tensor], prefix: str, device) -> Callable:
    """name -> the tensor `prefix + name` on `device`."""
    def get(name: str) -> torch.Tensor:
        return state[prefix + name].to(device)

    return get


def stack(n: int, leaf: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """[n, ...] stack of leaf(0..n-1), filled one leaf at a time into one
    allocation on the leaves' device (no list of copies beside it)."""
    out = None
    for i in range(n):
        t = leaf(i)
        if out is None:
            out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        out[i].copy_(t)
    return out


def input_major(key: str, w: torch.Tensor) -> torch.Tensor:
    """Linear weights (tree keys ending in `_w`) go from torch's [out, in] to
    the tree's input-major [in, out]; every other leaf stays as it is."""
    return w.T if key.endswith("_w") else w


def stacked_layers(get: Callable, n: int, pattern: str, names: Mapping[str, str]) -> Dict:
    """{tree key: [n, ...] stack of layer i's `pattern.format(i) + name`}."""
    return {
        key: stack(n, lambda i, key=key, name=name: input_major(key, get(pattern.format(i) + name)))
        for key, name in names.items()
    }


LLAMA_LAYER_NAMES = {
    "attn_norm": "input_layernorm.weight", "q_w": "self_attn.q_proj.weight",
    "k_w": "self_attn.k_proj.weight", "v_w": "self_attn.v_proj.weight",
    "o_w": "self_attn.o_proj.weight", "mlp_norm": "post_attention_layernorm.weight",
    "gate_w": "mlp.gate_proj.weight", "up_w": "mlp.up_proj.weight",
    "down_w": "mlp.down_proj.weight",
}


def convert_llama(state: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                  prefix: str = "language_model.", device="cpu") -> Dict:
    return tree_from_leaves(iter_llama(state, cfg, prefix, device))


def iter_llama(state: Mapping[str, torch.Tensor], cfg: LlamaConfig,
               prefix: str = "language_model.", device="cpu"):
    """(path, leaf) of convert_llama, each leaf read and stacked on `device`
    only when the caller asks for it."""
    get = getter(state, prefix, device)
    yield ("embed",), get("model.embed_tokens.weight")
    for key, name in LLAMA_LAYER_NAMES.items():
        yield ("layers", key), stack(cfg.num_layers, lambda i, key=key, name=name: input_major(
            key, get(f"model.layers.{i}." + name)))
    yield ("norm",), get("model.norm.weight")
    yield ("lm_head",), get("lm_head.weight").T.contiguous()


def resample_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """Resample a square [N, D] patch position-embedding grid to
    [new_grid^2, D] f32, bicubic with antialias: what timm applies when a
    model is created at a non-native `img_size` (resample_abs_pos_embed).
    The same grid comes back as it is."""
    old_grid = int(round(pos.shape[0] ** 0.5))
    if old_grid * old_grid != pos.shape[0]:
        raise ValueError(f"pos embed length {pos.shape[0]} is not a square grid")
    if old_grid == new_grid:
        return pos
    t = pos.float().reshape(1, old_grid, old_grid, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(new_grid, new_grid), mode="bicubic", antialias=True)
    return t.permute(0, 2, 3, 1).reshape(new_grid * new_grid, -1)


VIT_BLOCK_NAMES = {
    "ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
    "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
    "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
    "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


def convert_vit(state: Mapping[str, torch.Tensor], cfg: ViTConfig, prefix: str,
                device="cpu") -> Dict:
    get = getter(state, prefix, device)

    def maybe(name):
        return get(name) if (prefix + name) in state else None

    # conv [D, 3, P, P] -> [P, P, 3, D] -> [P*P*3, D] (vit.patchify order)
    conv_w = get("patch_embed.proj.weight")
    kernel = conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])

    pos = get("pos_embed")[0]  # [N(+1), D]
    cls_pos = None
    if cfg.use_cls_token and pos.shape[0] == int(round((pos.shape[0] - 1) ** 0.5)) ** 2 + 1:
        # embed_class layout: row 0 belongs to cls; fold it into the cls token
        cls_pos, pos = pos[0], pos[1:]
    # non-native resolution (the 336/384px zoo variants): resample the grid
    pos = resample_pos_embed(pos, cfg.image_size // cfg.patch_size).contiguous()

    # only the blocks that run (0..depth-2): the checkpoint's final block
    # and final norm are dead in the OpenVLA tap path (modeling_prismatic.py:85-87)
    blocks = stacked_layers(get, cfg.tap_layer, "blocks.{}.", VIT_BLOCK_NAMES)
    if cfg.use_layerscale:
        for ls in ("ls1", "ls2"):
            def leaf(i, ls=ls):
                p = f"blocks.{i}.{ls}."
                return get(p + ("scale_factor" if prefix + p + "scale_factor" in state else "gamma"))

            blocks[ls] = stack(cfg.tap_layer, leaf)

    patch_embed: Dict = {"kernel": kernel}
    bias = maybe("patch_embed.proj.bias")  # absent on pre-norm (CLIP) towers
    if bias is not None:
        patch_embed["bias"] = bias
    params: Dict = {"patch_embed": patch_embed, "pos_embed": pos, "blocks": blocks}
    if cfg.use_cls_token:
        cls = get("cls_token").reshape(1, -1)
        params["cls_token"] = cls if cls_pos is None else cls + cls_pos[None]
    if cfg.num_reg_tokens:
        params["reg_tokens"] = get("reg_token").reshape(cfg.num_reg_tokens, -1)
    if cfg.pre_norm:
        params["norm_pre"] = {"scale": get("norm_pre.weight"), "bias": get("norm_pre.bias")}
    return params


def convert_projector(state: Mapping[str, torch.Tensor], prefix: str = "projector.",
                      device="cpu") -> Dict:
    """Fused checkpoints carry the 3-layer fc1/fc2/fc3 MLP; single-tower ones
    the 2-layer fc1/fc2 (modeling_prismatic.py:127-156)."""
    get = getter(state, prefix, device)
    arity = 3 if prefix + "fc3.weight" in state else 2
    out = {}
    for i in range(1, arity + 1):
        out[f"fc{i}_w"] = get(f"fc{i}.weight").T.contiguous()
        out[f"fc{i}_b"] = get(f"fc{i}.bias")
    return out


def convert_state_dict(state: Mapping[str, torch.Tensor], cfg: VLAConfig, device="cpu") -> Dict:
    vision = {"dino": convert_vit(state, cfg.dino, "vision_backbone.featurizer.", device)}
    if cfg.siglip is not None:
        vision["siglip"] = convert_vit(state, cfg.siglip, "vision_backbone.fused_featurizer.",
                                       device)
    if isinstance(cfg.llm, PhiConfig):
        from .phi import convert_phi

        llm = convert_phi(state, cfg.llm, device=device)
    else:
        llm = convert_llama(state, cfg.llm, device=device)
    return {"vision": vision, "projector": convert_projector(state, device=device), "llm": llm}


def iter_checkpoint_leaves(path: str, cfg: VLAConfig, device="cuda", dtype=None):
    """(path, leaf) of load_checkpoint_dir (cast to `dtype` if given). The
    files are opened and the device resolved now, so a missing directory,
    shard or card raises here. For a Llama-family VLA, the vision towers and
    the projector are converted whole, then each LLM leaf is read, stacked
    and cast on `device` only when the caller asks for it, and no leaf is
    kept once it is handed over: a caller that cuts and drops each one holds
    one full stacked leaf at a time. A Phi VLA is converted whole."""
    dev = resolve_device(device)
    state = read_state_dict(path)

    def cast(t):
        return t if dtype is None else t.to(dtype)

    def leaves():
        if isinstance(cfg.llm, PhiConfig):
            for p, leaf in tree_leaves(convert_state_dict(state, cfg, dev)):
                yield p, cast(leaf)
            return
        vision = {"dino": convert_vit(state, cfg.dino, "vision_backbone.featurizer.", dev)}
        if cfg.siglip is not None:
            vision["siglip"] = convert_vit(state, cfg.siglip, "vision_backbone.fused_featurizer.", dev)
        head = {"vision": vision, "projector": convert_projector(state, device=dev)}
        del vision
        for p, leaf in tree_leaves(head):
            yield p, cast(leaf)
        del head, leaf
        for p, leaf in iter_llama(state, cfg.llm, device=dev):
            leaf = cast(leaf)  # the stack as read goes before the yield
            yield ("llm",) + p, leaf
            del leaf  # and this one before the next stack is read

    return leaves()


def load_checkpoint_dir(path: str, cfg: VLAConfig, device="cuda") -> Dict:
    """A local HF OpenVLA checkpoint directory (safetensors shards, with or
    without an index) -> the parameter tree on `device`, in the
    checkpoint's dtypes. A missing directory, shard or tensor raises."""
    return tree_from_leaves(iter_checkpoint_leaves(path, cfg, device))


def cast_tree(tree: Mapping, dtype: torch.dtype) -> Dict:
    """Every leaf of a parameter tree in `dtype` (a leaf already in it is
    kept, not copied)."""
    return {k: cast_tree(v, dtype) if isinstance(v, Mapping) else v.to(dtype)
            for k, v in tree.items()}


def load_norm_stats(path: str) -> Dict:
    """`dataset_statistics.json` next to a checkpoint (the eval path's
    source of q01/q99 masks, experiments/robot/openvla_utils.py:60-70), or
    else the `norm_stats` field of its config.json."""
    stats_path = os.path.join(path, "dataset_statistics.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            return json.load(f)
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)["norm_stats"]
