"""Models of the port: configs, vision towers, projector, the Llama and Phi-2
stacks, quantization, greedy action decode, HF checkpoint conversion, the
model zoo, and the JAX weight bridge."""

from .config import (
    DINOV2_VIT_L,
    LLAMA2_7B,
    OPENVLA_7B,
    PHI_2,
    REGISTRY,
    SIGLIP_SO400M,
    TINY_LLAMA,
    VLA_TINY,
    LlamaConfig,
    PhiConfig,
    ViTConfig,
    VLAConfig,
    get_config,
)
from .convert import convert_state_dict, load_checkpoint_dir, load_norm_stats
from .llama import cross_entropy_loss, embed_tokens, init_llama_params, llama_apply, rms_norm
from .phi import convert_phi, init_phi_params, phi_apply
from .registry import (
    GLOBAL_REGISTRY,
    MODEL_REGISTRY,
    ModelSpec,
    UnsupportedArchitecture,
    available_model_names,
    available_models,
    build_config,
    get_model_description,
    hub_files,
    load,
    make_image_processor,
)
from .vit import init_vit_params, vit_features
from .vlm import (
    VLAOutput,
    action_logit_slice,
    init_vla_params,
    param_count,
    projector_apply,
    vision_features,
    vla_forward,
)

__all__ = [
    "DINOV2_VIT_L", "GLOBAL_REGISTRY", "LLAMA2_7B", "MODEL_REGISTRY", "OPENVLA_7B", "PHI_2",
    "REGISTRY", "SIGLIP_SO400M", "TINY_LLAMA", "VLA_TINY", "LlamaConfig", "ModelSpec",
    "PhiConfig", "UnsupportedArchitecture", "ViTConfig", "VLAConfig", "VLAOutput",
    "action_logit_slice", "available_model_names", "available_models", "build_config",
    "convert_phi", "convert_state_dict", "cross_entropy_loss", "embed_tokens",
    "get_config", "get_model_description", "hub_files", "init_llama_params",
    "init_phi_params", "init_vit_params", "init_vla_params", "llama_apply", "load",
    "load_checkpoint_dir", "load_norm_stats", "make_image_processor", "param_count",
    "phi_apply", "projector_apply", "rms_norm", "vision_features", "vit_features",
    "vla_forward",
]
