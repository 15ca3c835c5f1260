"""Model configuration dataclasses + named registry.

The same field names and values as the JAX package's `models/config.py`, so
one config describes a model in both packages. The flagship `openvla-7b` is
the dinosiglip-224px + Llama-2-7B stack:
  - DINOv2 ViT-L/14 reg4 (timm `vit_large_patch14_reg4_dinov2.lvd142m`)
  - SigLIP ViT-so400m/14 (timm `vit_so400m_patch14_siglip_224`)
  - Llama-2-7B w/ 32064-row padded embedding (vocab 32000 + pad to mult. 64)

Fields that select JAX-only machinery (`attn_chunk`, `remat_group`,
`scan_unroll`) are kept for a like-for-like config and read nowhere in the
port. `attn_impl` is read only for "flash" (the B1/B2 kernels on every
attention, raising where they cannot take the input); "xla" and "chunked"
both let `ops/attention.attend` choose; any other value is refused. The
serving slice reads neither.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    mlp_hidden: int
    patch_size: int = 14
    image_size: int = 224
    num_reg_tokens: int = 0
    use_cls_token: bool = False
    use_layerscale: bool = False
    # DINOv2-reg models add pos-embed to patch tokens only, then prepend
    # cls/reg tokens (timm `no_embed_class=True`); SigLIP has no prefix tokens.
    ln_eps: float = 1e-6
    # CLIP towers (timm pre_norm=True): LayerNorm after pos-embed/prefix
    # insertion, and no patch-embed bias.
    pre_norm: bool = False
    # OpenAI CLIP checkpoints use the quick-GELU approximation x*sigmoid(1.702x).
    use_quick_gelu: bool = False

    @property
    def num_patches(self) -> int:
        # floor semantics, like a stride-P conv on a non-multiple image
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_cls_token else 0) + self.num_reg_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def tap_layer(self) -> int:
        """Blocks run before the feature tap: OpenVLA taps the second-to-last
        block's output, so depth-1 blocks run."""
        return self.depth - 1


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32064
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    attn_impl: str = "chunked"
    attn_chunk: int | None = 64
    remat_group: int = 1
    scan_unroll: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class PhiConfig:
    """Phi-2 decoder dims (microsoft/phi-2): LayerNorm with bias, parallel
    attn+MLP residual, partial rotary, biased projections and lm_head."""
    vocab_size: int = 51200
    hidden_size: int = 2560
    num_layers: int = 32
    num_heads: int = 32
    intermediate_size: int = 10240
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5
    max_seq_len: int = 2048
    attn_impl: str = "chunked"
    attn_chunk: Optional[int] = 64

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads  # Phi-2 has no GQA


@dataclass(frozen=True)
class DeepseekV3Config:
    """The DeepSeek-V3 decoder (HF `model_type: deepseek_v3`, its own
    `modeling_deepseek.py`): multi-head latent attention (MLA) without a
    query compression, each head's query/key `qk_nope_head_dim` +
    `qk_rope_head_dim` wide and its value `v_head_dim`, the keys and values
    read up from a `kv_lora_rank` latent and one rotary key shared by every
    head; the first `first_k_dense_replace` layers with a dense SwiGLU MLP,
    the rest with `n_routed_experts` SwiGLU experts of which each token reads
    `num_experts_per_tok` (sigmoid scores plus a correction bias choose them,
    the chosen unbiased scores, normalized and scaled by
    `routed_scaling_factor`, weigh them) beside `n_shared_experts` experts
    that every token reads. The field names are the HF config's where the
    port has no name of its own."""
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_eps: float = 1e-5

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def shared_intermediate_size(self) -> int:
        """The shared experts as one SwiGLU (HF `DeepseekV3MLP` of
        moe_intermediate_size * n_shared_experts)."""
        return self.moe_intermediate_size * self.n_shared_experts


@dataclass(frozen=True)
class VLAConfig:
    name: str
    dino: ViTConfig
    siglip: Optional[ViTConfig]
    llm: "LlamaConfig | PhiConfig | DeepseekV3Config"
    pad_token_id: int = 32000
    pad_to_multiple_of: int = 64
    n_action_bins: int = 256
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def use_fused_vision_backbone(self) -> bool:
        return self.siglip is not None

    @property
    def vision_dim(self) -> int:
        return self.dino.embed_dim + (self.siglip.embed_dim if self.siglip else 0)

    @property
    def num_patches(self) -> int:
        return self.dino.num_patches

    @property
    def action_vocab_size(self) -> int:
        """De-tokenization vocab: padded vocab minus the pad-to-multiple rows."""
        return self.llm.vocab_size - self.pad_to_multiple_of


DINOV2_VIT_L = ViTConfig(
    embed_dim=1024, depth=24, num_heads=16, mlp_hidden=4096,
    num_reg_tokens=4, use_cls_token=True, use_layerscale=True,
)
SIGLIP_SO400M = ViTConfig(
    embed_dim=1152, depth=27, num_heads=16, mlp_hidden=4304,
)
CLIP_VIT_L = ViTConfig(  # timm vit_large_patch14_clip_224.openai
    embed_dim=1024, depth=24, num_heads=16, mlp_hidden=4096,
    use_cls_token=True, pre_norm=True, use_quick_gelu=True, ln_eps=1e-5,
)
CLIP_VIT_L_336 = dataclasses.replace(CLIP_VIT_L, image_size=336)
SIGLIP_SO400M_384 = dataclasses.replace(SIGLIP_SO400M, image_size=384)
IN1K_VIT_L = ViTConfig(  # timm vit_large_patch16_224.augreg_in21k_ft_in1k
    embed_dim=1024, depth=24, num_heads=16, mlp_hidden=4096,
    patch_size=16, use_cls_token=True,
)
DINOV2_VIT_L_336 = dataclasses.replace(DINOV2_VIT_L, image_size=336)
DINOV2_VIT_L_384 = dataclasses.replace(DINOV2_VIT_L, image_size=384)
LLAMA2_7B = LlamaConfig(attn_impl="flash")
LLAMA2_13B = LlamaConfig(
    hidden_size=5120, num_layers=40, num_heads=40, num_kv_heads=40,
    intermediate_size=13824, attn_impl="flash",
)
MISTRAL_7B = LlamaConfig(
    vocab_size=32064, intermediate_size=14336, num_kv_heads=8, attn_impl="chunked",
)
PHI_2 = PhiConfig()
# moonshotai/Moonlight-16B-A3B config.json: q_lora_rank null, n_group =
# topk_group = 1 (the group step chooses nothing), scoring sigmoid, topk
# method noaux_tc, norm_topk_prob true, no rope scaling, untied head
MOONLIGHT_16B_A3B = DeepseekV3Config()

OPENVLA_7B = VLAConfig(name="openvla-7b", dino=DINOV2_VIT_L, siglip=SIGLIP_SO400M, llm=LLAMA2_7B)
# OpenVLA's VLA (its towers and fused projector) on Moonlight's decoder; the
# attack keeps the action-token ids 31744-31999 of the port's constants
VLA_MOONLIGHT_16B_A3B = VLAConfig(name="vla-moonlight-16b-a3b", dino=DINOV2_VIT_L, siglip=SIGLIP_SO400M,
                                  llm=MOONLIGHT_16B_A3B)

# Tiny config for tests: same structural quirks (fused backbone, reg tokens,
# layerscale, padded vocab) at toy scale, in fp32.
TINY_DINO = ViTConfig(
    embed_dim=32, depth=3, num_heads=2, mlp_hidden=64, patch_size=14,
    image_size=56, num_reg_tokens=4, use_cls_token=True, use_layerscale=True,
)
TINY_SIGLIP = ViTConfig(
    embed_dim=48, depth=4, num_heads=2, mlp_hidden=96, patch_size=14, image_size=56,
)
TINY_LLAMA = LlamaConfig(
    vocab_size=32064, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
    intermediate_size=128, max_seq_len=512,
)
VLA_TINY = VLAConfig(
    name="vla-tiny", dino=TINY_DINO, siglip=TINY_SIGLIP, llm=TINY_LLAMA,
    dtype="float32", remat=False,
)

# LIBERO finetunes share the 7B architecture; they differ only in weights +
# norm_stats.
REGISTRY = {
    "openvla-7b": OPENVLA_7B,
    "openvla-7b-finetuned-libero-spatial": OPENVLA_7B,
    "openvla-7b-finetuned-libero-object": OPENVLA_7B,
    "openvla-7b-finetuned-libero-goal": OPENVLA_7B,
    "openvla-7b-finetuned-libero-10": OPENVLA_7B,
    "vla-tiny": VLA_TINY,
    "vla-moonlight-16b-a3b": VLA_MOONLIGHT_16B_A3B,
}


def get_config(name: str) -> VLAConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown model config '{name}'; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def torch_dtype(cfg: VLAConfig):
    """The config's dtype string as a torch dtype."""
    import torch

    return getattr(torch, cfg.dtype)
