"""Prismatic/OpenVLA multimodal pieces in PyTorch: fused dual-ViT features,
the MLP projector, the attack's multimodal forward (`vla_forward`), and the
`VLA` module that holds every param.

  - fused backbone: per-backbone features concatenated on the embedding dim;
    the backbone split is the leading stack axis of the [B, 2, H, W, 3]
    pixel layout (models/vlm.py of the JAX package);
  - projector: fc1 -> GELU -> fc2 -> GELU -> fc3 (fused variant) or
    fc1 -> GELU -> fc2 (single tower), exact-erf GELU in fp32.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import not_ported
from .config import PhiConfig, VLAConfig, torch_dtype
from .llama import Llama, cross_entropy_loss, embed_tokens, init_llama_params, llama_apply
from .param_tree import ParamTree
from .vit import ViT, _normal, init_vit_params, vit_features


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def projector_apply(params: Dict, features: torch.Tensor) -> torch.Tensor:
    """Fused (3-layer) or single-tower (2-layer) MLP; the arity is read off
    the params."""
    x = _gelu(features @ params["fc1_w"] + params["fc1_b"])
    x = x @ params["fc2_w"] + params["fc2_b"]
    if "fc3_w" not in params:
        return x
    return _gelu(x) @ params["fc3_w"] + params["fc3_b"]


def vision_features(params: Dict, cfg: VLAConfig, pixel_values: torch.Tensor,
                    remat: bool = False) -> torch.Tensor:
    """pixel_values: [B, 2, H, W, 3] (DINO-normed, SigLIP-normed) ->
    [B, num_patches, dino_dim + siglip_dim]."""
    dino = vit_features(params["dino"], cfg.dino, pixel_values[:, 0], remat=remat)
    if cfg.siglip is None:
        return dino
    sig = vit_features(params["siglip"], cfg.siglip, pixel_values[:, 1], remat=remat)
    return torch.cat([dino, sig], dim=-1)


class VLAOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    # TEXT-REGION logits [B, S, V] f32: position j holds the logits of
    # extended position num_patches + j (predicting text token j + 1); the
    # image-patch positions' logits are never read, so never computed
    logits: torch.Tensor


def vla_forward(
    params: Dict,
    cfg: VLAConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    pixel_values: Optional[torch.Tensor],
    labels: Optional[torch.Tensor] = None,
) -> VLAOutput:
    """The multimodal training/attack forward: the projected patch tokens
    are inserted after BOS (and always attended), the decoder computes the
    text region's logits, and `labels` give the shifted CE.
    `pixel_values=None` runs the decoder over input_ids alone (full-row
    logits). With `cfg.remat` the vision encode is one outer checkpoint
    (only the pixels and the projected patches stay saved) over per-block
    checkpoints, and every decoder block is checkpointed."""
    if isinstance(cfg.llm, PhiConfig):
        raise not_ported("the Phi-2 decoder", "slice 4: model zoo")
    llm = params["llm"]
    if pixel_values is None:
        logits = llama_apply(llm, cfg.llm, embed_tokens(llm, input_ids),
                             attention_mask=attention_mask, remat=cfg.remat)
        loss = cross_entropy_loss(logits, labels) if labels is not None else None
        return VLAOutput(loss=loss, logits=logits)

    def encode(pixels):
        return projector_apply(params["projector"],
                               vision_features(params["vision"], cfg, pixels, remat=cfg.remat))

    if cfg.remat:
        projected = checkpoint(encode, pixel_values, use_reentrant=False)
    else:
        projected = encode(pixel_values)

    emb = embed_tokens(llm, input_ids)
    mm_emb = torch.cat([emb[:, :1], projected.to(emb.dtype), emb[:, 1:]], dim=1)
    ones = torch.ones(projected.shape[:2], dtype=attention_mask.dtype, device=attention_mask.device)
    mm_mask = torch.cat([attention_mask[:, :1], ones, attention_mask[:, 1:]], dim=1)
    logits = llama_apply(llm, cfg.llm, mm_emb, attention_mask=mm_mask, remat=cfg.remat,
                         logits_tail=input_ids.shape[1])
    # every valid label lives in the text region and labels[0] (BOS) is
    # IGNORE, so the shifted CE over the text logits is the extended row's
    loss = cross_entropy_loss(logits, labels) if labels is not None else None
    return VLAOutput(loss=loss, logits=logits)


def action_logit_slice(logits: torch.Tensor, cfg: VLAConfig, text_len: int) -> torch.Tensor:
    """Positions predicting text tokens 1..S-1, aligned with labels[:, 1:]:
    with text-region logits, `[:, :-1]`. Returns [B, S-1, V]."""
    del cfg, text_len
    return logits[:, :-1, :]


class Projector(ParamTree):
    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return projector_apply(self.tree(), features)


class VLA(ParamTree):
    """Every param of a VLA under its JAX pytree path: `vision.dino.*`,
    `vision.siglip.*`, `projector.*`, `llm.*`. `tree()` is the nested dict
    the functional code takes."""

    def __init__(self, cfg: VLAConfig, tree: Mapping) -> None:
        super().__init__()
        self.cfg = cfg
        vision = ParamTree()
        vision.add_module("dino", ViT(cfg.dino, tree["vision"]["dino"]))
        if cfg.siglip is not None:
            vision.add_module("siglip", ViT(cfg.siglip, tree["vision"]["siglip"]))
        self.vision = vision
        self.projector = Projector(tree["projector"])
        self.llm = Llama(cfg.llm, tree["llm"])

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Projected patch embeddings [B, num_patches, llm_dim]."""
        return self.projector(vision_features(self.vision.tree(), self.cfg, pixel_values))


def init_vla_params(
    gen: torch.Generator, cfg: VLAConfig, device: Optional[torch.device] = None,
) -> Dict:
    """Random params in the JAX pytree layout, in the config's dtype, drawn
    from `gen` on `device` (the generator's device by default)."""
    if isinstance(cfg.llm, PhiConfig):
        raise not_ported("the Phi-2 decoder", "slice 4: model zoo")
    device = gen.device if device is None else device
    dtype = torch_dtype(cfg)
    vision: Dict = {"dino": init_vit_params(gen, cfg.dino, dtype, device)}
    if cfg.siglip is not None:
        vision["siglip"] = init_vit_params(gen, cfg.siglip, dtype, device)

    vdim, ldim = cfg.vision_dim, cfg.llm.hidden_size

    def normal(shape):
        return _normal(gen, shape, dtype, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    if cfg.use_fused_vision_backbone:
        hidden = 4 * vdim
        projector = {
            "fc1_w": normal((vdim, hidden)), "fc1_b": zeros(hidden),
            "fc2_w": normal((hidden, ldim)), "fc2_b": zeros(ldim),
            "fc3_w": normal((ldim, ldim)), "fc3_b": zeros(ldim),
        }
    else:
        projector = {
            "fc1_w": normal((vdim, ldim)), "fc1_b": zeros(ldim),
            "fc2_w": normal((ldim, ldim)), "fc2_b": zeros(ldim),
        }
    llm = init_llama_params(gen, cfg.llm, dtype, device)
    return {"vision": vision, "projector": projector, "llm": llm}
