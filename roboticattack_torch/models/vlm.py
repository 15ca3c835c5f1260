"""Prismatic/OpenVLA multimodal pieces in PyTorch: fused dual-ViT features,
the MLP projector, the attack's multimodal forward (`vla_forward`), and the
`VLA` module that holds every param.

  - fused backbone: per-backbone features concatenated on the embedding dim;
    the backbone split is the leading stack axis of the [B, 2, H, W, 3]
    pixel layout (models/vlm.py of the JAX package);
  - projector: fc1 -> GELU -> fc2 -> GELU -> fc3 (fused variant) or
    fc1 -> GELU -> fc2 (single tower), exact-erf GELU in fp32;
  - decoder: Llama-family by default, Phi-2 for the `phi-2+3b` zoo entry,
    DeepSeek-V3 (latent attention, sparse experts) for a DeepseekV3Config.

Under a model axis (`mesh`, parallel.make_mesh(model > 1)) the vision
towers stay whole and run without a collective on every rank; the
projector is cut (fc1 column-, fc2 row-parallel, fc3 whole) when
parallel.shard_params was given `shard_projector`, whole otherwise (read off
fc1's width); the embedding lookup and the decoder are vocab- and
head-parallel (models/llama.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.tensor_parallel import copy_to_model, reduce_from_model, split
from ..utils.profiling import span
from . import deepseek
from .config import DeepseekV3Config, PhiConfig, VLAConfig, torch_dtype
from .llama import Llama, check_shard, cross_entropy_loss, embed_tokens, iter_llama_params, llama_apply
from .param_tree import ParamTree, tree_from_leaves, tree_leaves
from .phi import Phi, init_phi_params, phi_apply
from .vit import ViT, _normal, init_vit_params, vit_features


def decoder_apply_fn(cfg: VLAConfig):
    """The decoder forward for this config: Llama-family by default, Phi-2
    for the one zoo entry that is not Llama-shaped (phi-2+3b), DeepSeek-V3
    for a DeepseekV3Config."""
    if isinstance(cfg.llm, DeepseekV3Config):
        return deepseek.deepseek_apply
    return phi_apply if isinstance(cfg.llm, PhiConfig) else llama_apply


def decoder_check_shard(cfg: VLAConfig):
    """The decoder's check of the params a rank holds (models/llama.py's
    for Llama and Phi, which read q widths of heads x head_dim)."""
    return deepseek.check_shard if isinstance(cfg.llm, DeepseekV3Config) else check_shard


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def projector_apply(params: Dict, features: torch.Tensor, mesh=None) -> torch.Tensor:
    """Fused (3-layer) or single-tower (2-layer) MLP; the arity is read off
    the params. With `mesh` (a model axis) fc1/fc2 are this rank's column
    and row slices: fc2's partial products are summed before its bias."""
    x = _gelu(copy_to_model(features, mesh) @ params["fc1_w"] + params["fc1_b"])
    x = reduce_from_model(x @ params["fc2_w"], mesh) + params["fc2_b"]
    if "fc3_w" not in params:
        return x
    return _gelu(x) @ params["fc3_w"] + params["fc3_b"]


def projector_mesh(params: Dict, cfg: VLAConfig, mesh):
    """`mesh` when the projector holds this rank's fc1/fc2 slices (read off
    fc1's width), None when it is whole; ValueError on any other width."""
    if not split(mesh):
        return None
    full = 4 * cfg.vision_dim if cfg.use_fused_vision_backbone else cfg.llm.hidden_size
    width = params["fc1_b"].shape[-1]
    if width == full:
        return None
    if width * mesh.tp != full:
        raise ValueError(f"projector fc1 of width {width}: neither whole ({full}) nor a slice of it over "
                         f"{mesh.tp} model ranks")
    return mesh


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
    mesh=None,
) -> VLAOutput:
    """The multimodal training/attack forward: the projected patch tokens
    are inserted after BOS (and always attended), the decoder computes the
    text region's logits, and `labels` give the shifted CE.
    `pixel_values=None` runs the decoder over input_ids alone (full-row
    logits). With `cfg.remat` the vision encode is one outer checkpoint
    (only the pixels and the projected patches stay saved) over per-block
    checkpoints, and every decoder block is checkpointed. With `mesh` (a
    model axis) `params` is this rank's shard and the logits its vocab
    slice; the loss is the whole rows' CE on every rank."""
    apply_fn = decoder_apply_fn(cfg)
    llm = params["llm"]
    decoder_check_shard(cfg)(llm, cfg.llm, mesh)
    if pixel_values is None:
        logits = apply_fn(llm, cfg.llm, embed_tokens(llm, input_ids, mesh),
                          attention_mask=attention_mask, remat=cfg.remat, mesh=mesh)
        loss = cross_entropy_loss(logits, labels, mesh) if labels is not None else None
        return VLAOutput(loss=loss, logits=logits)
    proj_mesh = projector_mesh(params["projector"], cfg, mesh)

    def encode(pixels):
        with span("vla.vision"):
            return projector_apply(params["projector"],
                                   vision_features(params["vision"], cfg, pixels, remat=cfg.remat), proj_mesh)

    if cfg.remat:
        # no RNG state stashed: nothing here draws random numbers (a CUDA graph's capture refuses it)
        projected = checkpoint(encode, pixel_values, use_reentrant=False, preserve_rng_state=False)
    else:
        projected = encode(pixel_values)

    emb = embed_tokens(llm, input_ids, mesh)
    mm_emb = torch.cat([emb[:, :1], projected.to(emb.dtype), emb[:, 1:]], dim=1)
    ones = torch.ones(projected.shape[:2], dtype=attention_mask.dtype, device=attention_mask.device)
    mm_mask = torch.cat([attention_mask[:, :1], ones, attention_mask[:, 1:]], dim=1)
    with span("vla.llm"):
        logits = apply_fn(llm, cfg.llm, mm_emb, attention_mask=mm_mask, remat=cfg.remat,
                          logits_tail=input_ids.shape[1], mesh=mesh)
    # every valid label lives in the text region and labels[0] (BOS) is
    # IGNORE, so the shifted CE over the text logits is the extended row's
    loss = cross_entropy_loss(logits, labels, mesh) if labels is not None else None
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
        if isinstance(cfg.llm, DeepseekV3Config):
            self.llm = deepseek.Deepseek(cfg.llm, tree["llm"])
        else:
            self.llm = (Phi if isinstance(cfg.llm, PhiConfig) else Llama)(cfg.llm, tree["llm"])

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Projected patch embeddings [B, num_patches, llm_dim]."""
        return self.projector(vision_features(self.vision.tree(), self.cfg, pixel_values))


def init_vla_params(
    gen: torch.Generator, cfg: VLAConfig, device: Optional[torch.device] = None,
) -> Dict:
    """Random params in the JAX pytree layout, in the config's dtype, drawn
    from `gen` on `device` (the generator's device by default)."""
    return tree_from_leaves(iter_vla_params(gen, cfg, device))


def iter_vla_params(gen: torch.Generator, cfg: VLAConfig, device: Optional[torch.device] = None):
    """(path, leaf) of init_vla_params: the vision towers and the projector
    as one draw each, then, for a Llama-family VLA, every LLM leaf drawn
    only when the caller asks for it (models.llama.iter_llama_params, and
    models.deepseek.iter_deepseek_params for a DeepSeek-V3 LLM) and not
    kept once it is handed over; a Phi LLM as one draw. The same draws
    in the same order, so the same values."""
    device = gen.device if device is None else device
    vision, projector = _init_vision_projector(gen, cfg, device)
    yield from tree_leaves({"vision": vision, "projector": projector})
    del vision, projector
    if isinstance(cfg.llm, PhiConfig):
        llm = tree_leaves(init_phi_params(gen, cfg.llm, torch_dtype(cfg), device))
    elif isinstance(cfg.llm, DeepseekV3Config):
        llm = deepseek.iter_deepseek_params(gen, cfg.llm, torch_dtype(cfg), device)
    else:
        llm = iter_llama_params(gen, cfg.llm, torch_dtype(cfg), device)
    for path, leaf in llm:
        yield ("llm",) + path, leaf
        del leaf  # dropped before the next leaf is drawn


def _init_vision_projector(gen: torch.Generator, cfg: VLAConfig, device) -> tuple:
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
    return vision, projector


def param_count(params: Dict) -> int:
    return sum(param_count(v) if isinstance(v, Mapping) else v.numel() for v in params.values())
