"""Vision Transformer (DINOv2-reg / SigLIP variants) in PyTorch.

Behavioral contract, as in the JAX package's `models/vit.py`:
  - features are the second-to-last block's output, patch tokens only,
    without the final norm (prefix tokens stripped);
  - DINOv2-reg: pos-embed on patch tokens only, then prepend [cls, reg x4];
    LayerScale after attn and mlp;
  - SigLIP: no prefix tokens, pos-embed on all patches, no LayerScale;
  - the 14x14/stride-14 patch embed is a reshape + one matmul (a
    non-overlapping conv is a block reshape), with the kernel stored
    [P*P*3, D] in (ph, pw, c) order;
  - LayerNorm (population variance) and GELU (exact erf) in fp32, matmuls
    in the param dtype.

Params (per backbone) keep the JAX pytree layout: patch_embed {kernel, bias},
pos_embed [num_patches, D], cls_token / reg_tokens / norm_pre (optional),
blocks: stacked [L, ...] arrays with input-major [D_in, D_out] weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import mha
from .config import ViTConfig
from .param_tree import ParamTree


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H//P)*(W//P), P*P*C] in (ph, pw, c) order.
    Non-multiple H/W are floor-cropped, matching a stride-P conv."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    images = images[:, : gh * patch, : gw * patch, :]
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, ph, pw, c]
    return x.reshape(b, gh * gw, patch * patch * c)


def _block(cfg: ViTConfig, x: torch.Tensor, p: Dict[str, torch.Tensor], li: int) -> torch.Tensor:
    """One pre-norm transformer block (timm Block semantics) on layer `li`
    of the stacked block params."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    y = layer_norm(x, p["ln1_scale"][li], p["ln1_bias"][li], cfg.ln_eps)
    qkv = y @ p["qkv_w"][li] + p["qkv_b"][li]
    qkv = qkv.reshape(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]
    attn = mha(qkv[0], qkv[1], qkv[2])
    attn = attn.transpose(1, 2).reshape(b, s, d)
    attn = attn @ p["proj_w"][li] + p["proj_b"][li]
    if cfg.use_layerscale:
        attn = attn * p["ls1"][li]
    x = x + attn

    y = layer_norm(x, p["ln2_scale"][li], p["ln2_bias"][li], cfg.ln_eps)
    y = y @ p["fc1_w"][li] + p["fc1_b"][li]
    yf = y.float()
    if cfg.use_quick_gelu:
        yf = yf * torch.sigmoid(1.702 * yf)
    else:
        yf = F.gelu(yf, approximate="none")
    y = yf.to(x.dtype)
    y = y @ p["fc2_w"][li] + p["fc2_b"][li]
    if cfg.use_layerscale:
        y = y * p["ls2"][li]
    return x + y


def vit_features(params: Dict, cfg: ViTConfig, images: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """images: [B, H, W, 3] (already normalized) -> [B, num_patches, D] patch
    features from the second-to-last block (no final norm, prefix stripped).
    params['blocks'] stacks only the `tap_layer` blocks that run. `remat`
    recomputes each block in the backward (torch.utils.checkpoint)."""
    dtype = params["patch_embed"]["kernel"].dtype
    x = patchify(images.to(dtype), cfg.patch_size)
    x = x @ params["patch_embed"]["kernel"]
    if "bias" in params["patch_embed"]:  # absent on pre-norm (CLIP) towers
        x = x + params["patch_embed"]["bias"]
    x = x + params["pos_embed"].to(dtype)

    prefix = []
    if cfg.use_cls_token:
        prefix.append(params["cls_token"].to(dtype).expand(x.shape[0], 1, cfg.embed_dim))
    if cfg.num_reg_tokens:
        prefix.append(
            params["reg_tokens"].to(dtype).expand(x.shape[0], cfg.num_reg_tokens, cfg.embed_dim)
        )
    if prefix:
        x = torch.cat(prefix + [x], dim=1)

    if cfg.pre_norm:
        x = layer_norm(x, params["norm_pre"]["scale"], params["norm_pre"]["bias"], cfg.ln_eps)

    for li in range(len(params["blocks"]["qkv_w"])):  # a stack, or a list of per-layer leaves
        if remat:
            x = checkpoint(_block, cfg, x, params["blocks"], li, use_reentrant=False)
        else:
            x = _block(cfg, x, params["blocks"], li)
    return x[:, cfg.num_prefix_tokens :, :]


class ViT(ParamTree):
    """One vision tower: its params under the JAX names, `forward` =
    vit_features."""

    def __init__(self, cfg: ViTConfig, tree: Dict) -> None:
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vit_features(self.tree(), self.cfg, images)


def _normal(gen: torch.Generator, shape, dtype, device, std=0.02) -> torch.Tensor:
    # in place: one f32 draw of the shape, not two (the same values)
    return torch.randn(shape, generator=gen, device=device).mul_(std).to(dtype)


def init_vit_params(
    gen: torch.Generator, cfg: ViTConfig, dtype=torch.float32,
    device: Optional[torch.device] = None,
) -> Dict:
    """Random init with the JAX package's shapes and scales (normal*0.02,
    zero biases, unit norms, LayerScale 1e-5), drawn from `gen` on `device`."""
    device = gen.device if device is None else device
    d, depth, mlp = cfg.embed_dim, cfg.tap_layer, cfg.mlp_hidden
    pdim = cfg.patch_size * cfg.patch_size * 3

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    patch_embed = {"kernel": normal((pdim, d))}
    if not cfg.pre_norm:
        patch_embed["bias"] = full((d,), 0.0)
    params = {
        "patch_embed": patch_embed,
        "pos_embed": normal((cfg.num_patches, d)),
        "blocks": {
            "ln1_scale": full((depth, d), 1.0),
            "ln1_bias": full((depth, d), 0.0),
            "qkv_w": normal((depth, d, 3 * d)),
            "qkv_b": full((depth, 3 * d), 0.0),
            "proj_w": normal((depth, d, d)),
            "proj_b": full((depth, d), 0.0),
            "ln2_scale": full((depth, d), 1.0),
            "ln2_bias": full((depth, d), 0.0),
            "fc1_w": normal((depth, d, mlp)),
            "fc1_b": full((depth, mlp), 0.0),
            "fc2_w": normal((depth, mlp, d)),
            "fc2_b": full((depth, d), 0.0),
        },
    }
    if cfg.use_layerscale:
        params["blocks"]["ls1"] = full((depth, d), 1e-5)
        params["blocks"]["ls2"] = full((depth, d), 1e-5)
    if cfg.use_cls_token:
        params["cls_token"] = normal((1, d))
    if cfg.num_reg_tokens:
        params["reg_tokens"] = normal((cfg.num_reg_tokens, d))
    if cfg.pre_norm:
        params["norm_pre"] = {"scale": full((d,), 1.0), "bias": full((d,), 0.0)}
    return params
