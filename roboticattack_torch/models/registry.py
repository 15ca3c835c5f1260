"""Pretrained-model ID registry and checkpoint acquisition, as in the JAX
package's `models/registry.py`.

The reference's 49-entry model-ID zoo with its alternate display names
(prismatic/models/registry.py), the per-ID structural specs (vision and LLM
backbone IDs, arch specifier, resize strategy; conf/models.py) and the
HF-Hub download + load (load.py:27-121). One call goes ID -> hub files ->
downloaded checkpoint -> the converted parameter tree on a device.

Entries are written as (id, names, structural overrides) on top of family
defaults; descriptions are made from the structural fields.

Every zoo architecture constructs: DINOv2 / SigLIP / CLIP (quick-GELU,
pre-norm) / IN1K towers, single or fused, at 224/336/384px, over Llama-2 /
Vicuna / Mistral decoders (models/llama.py) and Phi-2 (models/phi.py).
`huggingface_hub` is imported only when an ID is fetched without an
injected `download_fn`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from .config import (
    CLIP_VIT_L,
    CLIP_VIT_L_336,
    DINOV2_VIT_L,
    DINOV2_VIT_L_336,
    DINOV2_VIT_L_384,
    IN1K_VIT_L,
    LLAMA2_7B,
    LLAMA2_13B,
    MISTRAL_7B,
    OPENVLA_7B,
    PHI_2,
    SIGLIP_SO400M,
    SIGLIP_SO400M_384,
    VLAConfig,
)

# HF Hub homes (reference load.py:27-29); the released OpenVLA checkpoints are
# standalone repos under the openvla org (TMA_wrapper.py:58, openvla_dataloader.py:85-100)
PRISMATIC_HUB_REPO = "TRI-ML/prismatic-vlms"
VLA_HUB_REPO = "openvla/openvla-dev"
OPENVLA_HUB_ORG = "openvla"


@dataclass(frozen=True)
class ModelSpec:
    model_id: str
    names: Tuple[str, ...] = ()
    vision_backbone_id: str = "clip-vit-l-336px"
    llm_backbone_id: str = "vicuna-v15-7b"
    arch_specifier: str = "no-align+gelu-mlp"
    image_resize_strategy: str = "letterbox"
    llm_max_length: int = 2048
    family: str = "prismatic"  # prismatic | openvla

    @property
    def description(self) -> Dict:
        return {
            "name": self.names[0] if self.names else self.model_id,
            "model_id": self.model_id,
            "visual_representation": self.vision_backbone_id,
            "image_processing": self.image_resize_strategy,
            "language_model": self.llm_backbone_id,
            "arch_specifier": self.arch_specifier,
            "family": self.family,
        }


MODEL_REGISTRY: Dict[str, ModelSpec] = {}
GLOBAL_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> None:
    MODEL_REGISTRY[spec.model_id] = spec
    GLOBAL_REGISTRY[spec.model_id] = spec
    for name in spec.names:
        GLOBAL_REGISTRY[name] = spec


def _family(defaults: ModelSpec):
    def add(model_id: str, *names: str, **over) -> None:
        register_model(replace(defaults, model_id=model_id, names=tuple(names), **over))

    return add


# === Prismatic VLM zoo (registry.py:9-688 names; conf/models.py structure) ===

# LLaVa-style base: CLIP ViT-L 336px letterbox over Vicuna v1.5 7B
_base = _family(ModelSpec(model_id=""))
_base("reproduction-llava-v15+7b", "LLaVa v1.5 7B (Reproduction)", arch_specifier="gelu-mlp")
_base("reproduction-llava-v15+13b", "LLaVa v1.5 13B (Reproduction)",
      arch_specifier="gelu-mlp", llm_backbone_id="vicuna-v15-13b")
_base("one-stage+7b", "One-Stage 7B", "Single-Stage 7B", "Frozen ViT (Single-Stage)",
      "CLIP ViT-L 336px (Letterbox)", "CLIP ViT-L 336px", "Vicuña v1.5 7B", "1 Epoch", "Base")
_base("one-stage+13b", "One-Stage 13B", "Single-Stage 13B", "Vicuña v1.5 13B",
      llm_backbone_id="vicuna-v15-13b")
_base("full-ft-multi-stage+7b", "Finetune ViT (Multi-Stage)", arch_specifier="gelu-mlp")
_base("full-ft-one-stage+7b", "Finetune ViT (Single-Stage)")

# visual-representation ablations (single-stage 7B)
_base("in1k-224px+7b", "IN1K ViT-L 224px", vision_backbone_id="in1k-vit-l")
_base("dinov2-224px+7b", "DINOv2 ViT-L 224px", vision_backbone_id="dinov2-vit-l")
_base("clip-224px+7b", "CLIP ViT-L 224px", vision_backbone_id="clip-vit-l")
_base("siglip-224px+7b", "SigLIP ViT-SO 224px", vision_backbone_id="siglip-vit-so400m")
_base("clip-336px-resize-crop+7b", "CLIP ViT-L 336px (Resize Crop)",
      image_resize_strategy="resize-crop")
_base("clip-336px-resize-naive+7b", "CLIP ViT-L 336px (Naive Resize)",
      "CLIP 336px (Naive Resize)", image_resize_strategy="resize-naive")
_base("siglip-384px-letterbox+7b", "SigLIP ViT-SO 384px (Letterbox)", "SigLIP ViT-SO 384px",
      vision_backbone_id="siglip-vit-so400m-384px")
_base("siglip-384px-resize-crop+7b", "SigLIP ViT-SO 384px (Resize Crop)",
      vision_backbone_id="siglip-vit-so400m-384px", image_resize_strategy="resize-crop")
_base("siglip-384px-resize-naive+7b", "SigLIP ViT-SO 384px (Naive Resize)",
      "SigLIP 384px (Naive Resize)",
      vision_backbone_id="siglip-vit-so400m-384px", image_resize_strategy="resize-naive")
_base("dinoclip-336px-letterbox+7b", "DINOv2 + CLIP 336px (Letterbox)",
      vision_backbone_id="dinoclip-vit-l-336px", arch_specifier="no-align+fused-gelu-mlp")
_base("dinoclip-336px-resize-naive+7b", "DINOv2 + CLIP 336px (Naive Resize)",
      vision_backbone_id="dinoclip-vit-l-336px", arch_specifier="no-align+fused-gelu-mlp",
      image_resize_strategy="resize-naive")
_base("dinosiglip-384px-letterbox+7b", "DINOv2 + SigLIP 384px (Letterbox)",
      vision_backbone_id="dinosiglip-vit-so-384px", arch_specifier="no-align+fused-gelu-mlp")
_base("dinosiglip-384px-resize-naive+7b", "DINOv2 + SigLIP 384px (Naive Resize)",
      vision_backbone_id="dinosiglip-vit-so-384px", arch_specifier="no-align+fused-gelu-mlp",
      image_resize_strategy="resize-naive")

# language-model ablations
_base("llama2+7b", "Llama-2 7B", llm_backbone_id="llama2-7b-pure")
_base("llama2+13b", "Llama-2 13B", llm_backbone_id="llama2-13b-pure")
_base("vicuna-no-cotraining+7b", "Vicuña v1.5 7B (No Co-training)")
_base("llama2-no-cotraining+7b", "Llama-2 7B (No Co-training)", llm_backbone_id="llama2-7b-pure")

# training-schedule / data ablations
_base("train-1.25-epochs+7b", "1.25 Epochs")
_base("train-1.5-epochs+7b", "1.5 Epochs")
_base("train-2-epochs+7b", "2 Epochs")
_base("train-3-epochs+7b", "3 Epochs")
_base("llava-lvis4v+7b", "Base + LVIS-4V")
_base("llava-lrv+7b", "Base + LRV")
_base("llava-lvis4v-lrv+7b", "Base + LVIS-4V + LRV")

# Prism models (resize-naive over Llama-2)
_prism = _family(ModelSpec(model_id="", llm_backbone_id="llama2-7b-pure",
                           image_resize_strategy="resize-naive"))
for _size, _llm in (("7b", "llama2-7b-pure"), ("13b", "llama2-13b-pure")):
    _n = _size.upper()
    _prism(f"prism-clip-controlled+{_size}", f"Prism-CLIP {_n} (Controlled)", llm_backbone_id=_llm)
    _prism(f"prism-clip+{_size}", f"Prism-CLIP {_n}", llm_backbone_id=_llm)
    # NOTE: the reference's prism-siglip+13b config keeps the CLIP tower
    # (conf/models.py Prism_13B_SigLIP — reproduced as-is)
    _prism(f"prism-siglip-controlled+{_size}", f"Prism-SigLIP {_n} (Controlled)",
           llm_backbone_id=_llm, vision_backbone_id="siglip-vit-so400m-384px")
    _prism(f"prism-siglip+{_size}", f"Prism-SigLIP {_n}", llm_backbone_id=_llm,
           vision_backbone_id="siglip-vit-so400m-384px" if _size == "7b" else "clip-vit-l-336px")
    _extra = ([f"Prism {_n} (Controlled)"])
    _prism(f"prism-dinosiglip-controlled+{_size}", f"Prism-DINOSigLIP {_n} (Controlled)",
           *_extra, llm_backbone_id=_llm, vision_backbone_id="dinosiglip-vit-so-384px",
           arch_specifier="no-align+fused-gelu-mlp")
    _prism(f"prism-dinosiglip+{_size}", f"Prism-DINOSigLIP {_n}", llm_backbone_id=_llm,
           vision_backbone_id="dinosiglip-vit-so-384px", arch_specifier="no-align+fused-gelu-mlp")
_prism("prism-dinosiglip-224px-controlled+7b", "Prism-DINOSigLIP 224px 7B (Controlled)",
       vision_backbone_id="dinosiglip-vit-so-224px", arch_specifier="no-align+fused-gelu-mlp")
_prism("prism-dinosiglip-224px+7b", "Prism-DINOSigLIP 224px 7B",
       vision_backbone_id="dinosiglip-vit-so-224px", arch_specifier="no-align+fused-gelu-mlp")
# registered in conf/models.py but absent from the public registry names
_prism("dinosiglip-224px-resize-naive+7b", vision_backbone_id="dinosiglip-vit-so-224px",
       arch_specifier="no-align+fused-gelu-mlp", llm_backbone_id="vicuna-v15-7b")

# additional LLM backbones
_base("llama2-chat+7b", "Llama-2 Chat 7B", llm_backbone_id="llama2-7b-chat")
_base("llama2-chat+13b", "Llama-2 Chat 13B", llm_backbone_id="llama2-13b-chat")
_base("mistral-v0.1+7b", "Mistral v0.1 7B", llm_backbone_id="mistral-v0.1-7b-pure")
_base("mistral-instruct-v0.1+7b", "Mistral Instruct v0.1 7B",
      llm_backbone_id="mistral-v0.1-7b-instruct")
_base("phi-2+3b", "Phi-2 3B", llm_backbone_id="phi-2-3b")

# === OpenVLA checkpoints (the attack targets; TMA_wrapper.py:30-41) ===
_vla = _family(ModelSpec(
    model_id="", vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="llama2-7b-pure", arch_specifier="no-align+fused-gelu-mlp",
    image_resize_strategy="resize-naive", family="openvla",
))
_vla("openvla-7b", "OpenVLA 7B")
for _suite in ("libero-spatial", "libero-object", "libero-goal", "libero-10"):
    _vla(f"openvla-7b-finetuned-{_suite}", f"OpenVLA 7B ({_suite} finetune)")


# === Listing / description API (load.py:33-48) ===

def available_models() -> List[str]:
    return list(MODEL_REGISTRY.keys())


def available_model_names() -> List[str]:
    return list(GLOBAL_REGISTRY.keys())


def get_model_description(model_id_or_name: str) -> Dict:
    if model_id_or_name not in GLOBAL_REGISTRY:
        raise ValueError(
            f"couldn't find '{model_id_or_name}'; check available_model_names()"
        )
    return GLOBAL_REGISTRY[model_id_or_name].description


# === Structural config construction ===

# vision_backbone_id -> (first tower, second tower|None); mirrors the
# reference's VISION_BACKBONES registry (models/materialize.py:29-51).
# Fused entries put the second tower in the VLAConfig `siglip` slot (its
# features are concatenated after the first tower's, dinoclip_vit.py:107-123).
_VISION = {
    "dinov2-vit-l": (DINOV2_VIT_L, None),
    "siglip-vit-so400m": (SIGLIP_SO400M, None),
    "in1k-vit-l": (IN1K_VIT_L, None),
    "clip-vit-l": (CLIP_VIT_L, None),
    "clip-vit-l-336px": (CLIP_VIT_L_336, None),
    "siglip-vit-so400m-384px": (SIGLIP_SO400M_384, None),
    "dinosiglip-vit-so-224px": (DINOV2_VIT_L, SIGLIP_SO400M),
    "dinosiglip-vit-so-384px": (DINOV2_VIT_L_384, SIGLIP_SO400M_384),
    "dinoclip-vit-l-336px": (DINOV2_VIT_L_336, CLIP_VIT_L_336),
}

_LLMS = {
    "llama2-7b-pure": LLAMA2_7B,
    "llama2-7b-chat": LLAMA2_7B,
    "vicuna-v15-7b": LLAMA2_7B,
    "llama2-13b-pure": LLAMA2_13B,
    "llama2-13b-chat": LLAMA2_13B,
    "vicuna-v15-13b": LLAMA2_13B,
    "mistral-v0.1-7b-pure": MISTRAL_7B,
    "mistral-v0.1-7b-instruct": MISTRAL_7B,
    "phi-2-3b": PHI_2,
}


class UnsupportedArchitecture(NotImplementedError):
    pass


def build_config(model_id_or_name: str) -> VLAConfig:
    """Structural VLAConfig for a registry ID. Every zoo architecture
    constructs: DINOv2 / SigLIP / CLIP (quick-GELU, pre-norm) / IN1K towers
    at 224/336/384px (pos-embeds resampled at conversion when the checkpoint
    resolution differs) over Llama-2/Vicuña/Mistral/Phi-2 decoders.
    Single-tower entries get the 2-layer gelu-mlp projector, fused entries
    the 3-layer fused-gelu-mlp (modeling_prismatic.py:127-156)."""
    spec = GLOBAL_REGISTRY.get(model_id_or_name)
    if spec is None:
        raise KeyError(f"unknown model '{model_id_or_name}'; see available_model_names()")
    if spec.family == "openvla":
        return OPENVLA_7B
    if spec.vision_backbone_id not in _VISION:
        raise UnsupportedArchitecture(
            f"vision backbone '{spec.vision_backbone_id}' is not constructible here "
            f"(supported: {sorted(_VISION)}); checkpoint acquisition still works"
        )
    if spec.llm_backbone_id not in _LLMS:
        raise UnsupportedArchitecture(
            f"LLM backbone '{spec.llm_backbone_id}' is not constructible here "
            f"(supported: {sorted(_LLMS)}); checkpoint acquisition still works"
        )
    dino, siglip = _VISION[spec.vision_backbone_id]
    return VLAConfig(name=spec.model_id, dino=dino, siglip=siglip,
                     llm=_LLMS[spec.llm_backbone_id])


def make_image_processor(model_id_or_name: str):
    """PrismaticImageProcessor wired for a registry entry: per-tower
    normalization stats (the timm data configs resolved at
    base_vision.py:137-139), native image size, and the spec's resize
    strategy. One stacked plane per tower, in tower order."""
    from .processing import (
        CLIP_MEAN,
        CLIP_STD,
        IMAGENET_MEAN,
        IMAGENET_STD,
        INCEPTION_MEAN,
        INCEPTION_STD,
        PrismaticImageProcessor,
    )
    from ..utils.constants import DINO_MEAN, DINO_STD, SIGLIP_MEAN, SIGLIP_STD

    spec = GLOBAL_REGISTRY.get(model_id_or_name)
    if spec is None:
        raise KeyError(f"unknown model '{model_id_or_name}'; see available_model_names()")
    if spec.family == "openvla":
        # the OpenVLA checkpoints ship bf16-rounded stats (TMA.py:46-47)
        return PrismaticImageProcessor(
            image_resize_strategy=spec.image_resize_strategy,
            means=(DINO_MEAN, SIGLIP_MEAN), stds=(DINO_STD, SIGLIP_STD),
        )
    stats = {
        "dinov2": (IMAGENET_MEAN, IMAGENET_STD),
        "clip": (CLIP_MEAN, CLIP_STD),
        "siglip": (INCEPTION_MEAN, INCEPTION_STD),
        "in1k": (INCEPTION_MEAN, INCEPTION_STD),
    }
    towers = {
        "dinosiglip": ("dinov2", "siglip"), "dinoclip": ("dinov2", "clip"),
    }.get(spec.vision_backbone_id.split("-")[0], (spec.vision_backbone_id.split("-")[0],))
    first, _ = _VISION[spec.vision_backbone_id]
    means = tuple(stats[t][0] for t in towers)
    stds = tuple(stats[t][1] for t in towers)
    return PrismaticImageProcessor(
        image_size=first.image_size,
        image_resize_strategy=spec.image_resize_strategy,
        means=means, stds=stds,
    )


# === Hub acquisition (load.py:52-121) ===

def hub_files(model_id_or_name: str) -> Tuple[str, List[str]]:
    """(repo_id, filenames) for a registry entry. OpenVLA checkpoints are
    standalone HF repos with safetensors shards; prismatic-zoo checkpoints
    live in one repo keyed by model_id (load.py:66-72)."""
    spec = GLOBAL_REGISTRY.get(model_id_or_name)
    if spec is None:
        raise KeyError(f"unknown model '{model_id_or_name}'; see available_model_names()")
    if spec.family == "openvla":
        return f"{OPENVLA_HUB_ORG}/{spec.model_id}", [
            "config.json",
            "dataset_statistics.json",
            "model.safetensors.index.json",
            "model-*.safetensors",
        ]
    return PRISMATIC_HUB_REPO, [
        f"{spec.model_id}/config.json",
        f"{spec.model_id}/checkpoints/latest-checkpoint.pt",
    ]


def _default_download(repo_id: str, patterns: List[str], cache_dir: Optional[str],
                      hf_token: Optional[str]) -> str:
    from huggingface_hub import snapshot_download

    return snapshot_download(
        repo_id=repo_id, allow_patterns=patterns, cache_dir=cache_dir, token=hf_token
    )


def load(
    model_id_or_path: str,
    cache_dir: Optional[str] = None,
    hf_token: Optional[str] = None,
    download_fn: Optional[Callable[..., str]] = None,
    config: Optional[VLAConfig] = None,
    device="cuda",
):
    """ID or local dir -> (params tree on `device`, VLAConfig, norm_stats|None).

    Mirrors the reference's `prismatic.load` entry point (load.py:52-121):
    a local directory is used in place; otherwise the ID resolves through
    GLOBAL_REGISTRY and the checkpoint is fetched from the HF Hub.
    `download_fn(repo_id, patterns, cache_dir, hf_token) -> local_dir` is
    injectable for offline tests (mock hub); `config` overrides the
    registry-derived architecture (tiny test checkpoints)."""
    from .convert import load_checkpoint_dir, load_norm_stats

    if os.path.isdir(model_id_or_path):
        local_dir, cfg = model_id_or_path, config or _config_for_dir(model_id_or_path)
    else:
        spec = GLOBAL_REGISTRY.get(model_id_or_path)
        if spec is None:
            raise KeyError(
                f"'{model_id_or_path}' is neither a local directory nor a known model ID"
            )
        if spec.family != "openvla":
            # prismatic zoo: acquire, then convert via the legacy-layout shim
            repo, patterns = hub_files(model_id_or_path)
            fetch = download_fn or _default_download
            local_dir = fetch(repo, patterns, cache_dir, hf_token)
            return _load_prismatic_dir(os.path.join(local_dir, spec.model_id), spec, config,
                                       device)
        cfg = config or build_config(model_id_or_path)
        repo, patterns = hub_files(model_id_or_path)
        fetch = download_fn or _default_download
        local_dir = fetch(repo, patterns, cache_dir, hf_token)

    params = load_checkpoint_dir(local_dir, cfg, device)
    has_stats = os.path.exists(os.path.join(local_dir, "dataset_statistics.json")) or \
        os.path.exists(os.path.join(local_dir, "config.json"))
    norm_stats = load_norm_stats(local_dir) if has_stats else None
    return params, cfg, norm_stats


def _config_for_dir(path: str) -> VLAConfig:
    """Resolve the config for a local checkpoint dir via its config.json
    model id when present; defaults to the OpenVLA-7B architecture."""
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            blob = json.load(f)
        mid = blob.get("model_id") or blob.get("_name_or_path", "")
        mid = os.path.basename(str(mid))
        if mid in GLOBAL_REGISTRY:
            try:
                return build_config(mid)
            except UnsupportedArchitecture:
                pass
    return OPENVLA_7B


# --- prismatic legacy checkpoint layout ------------------------------------------

def prismatic_to_hf_names(state: Dict) -> Dict:
    """Rename a legacy PrismaticVLM state dict (vlms/prismatic.py module tree:
    vision_backbone.{dino_,siglip_,}featurizer / projector.projector.{0,2,4}
    / llm_backbone.llm) to the HF OpenVLA names convert_state_dict expects."""
    renames = [
        ("vision_backbone.dino_featurizer.", "vision_backbone.featurizer."),
        ("vision_backbone.siglip_featurizer.", "vision_backbone.fused_featurizer."),
        ("vision_backbone.clip_featurizer.", "vision_backbone.fused_featurizer."),
        ("projector.projector.0.", "projector.fc1."),
        ("projector.projector.2.", "projector.fc2."),
        ("projector.projector.4.", "projector.fc3."),
        ("llm_backbone.llm.", "language_model."),
    ]
    out = {}
    for key, val in state.items():
        for old, new in renames:
            if key.startswith(old):
                key = new + key[len(old):]
                break
        out[key] = val
    return out


def read_prismatic_state_dict(path: str) -> Dict:
    """Raw state of a TRI-ML/prismatic-vlms checkpoint dir — torch
    'latest-checkpoint.pt' holding {'model': {module: state_dict}}
    (load.py:60-67, ddp.py:26-53), flattened, cast to f32 as in the JAX
    package, and renamed to the HF OpenVLA tensor names the converter takes."""
    import torch

    ckpt = torch.load(
        os.path.join(path, "checkpoints", "latest-checkpoint.pt"),
        map_location="cpu", weights_only=True,
    )
    flat = {}
    for module, sd in ckpt["model"].items():
        for k, v in sd.items():
            flat[f"{module}.{k}"] = v.to(torch.float32)
    return prismatic_to_hf_names(flat)


def _load_prismatic_dir(path: str, spec: ModelSpec, config: Optional[VLAConfig] = None,
                        device="cuda"):
    from ..utils.device import resolve_device
    from .convert import convert_state_dict

    dev = resolve_device(device)
    cfg = config or build_config(spec.model_id)  # raises UnsupportedArchitecture early
    params = convert_state_dict(read_prismatic_state_dict(path), cfg, dev)
    return params, cfg, None
