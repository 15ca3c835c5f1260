"""Registered VLA training-run configurations (draccus-equivalent).

The JAX package's `training/conf.py`, after the reference's
prismatic/conf/vla.py:20-235: one
`VLARunConfig` dataclass holding the full run contract (base VLM, freeze
stage, data mixture, optimization + strategy knobs) with every reference
experiment variant registered by its vla_id. Values are the reference's
constants; `expected_world_size` counts ranks (one card each).

Load one with
    cfg = VLARunConfig.get_choice_class("prism-dinosiglip-224px+mx-bridge")()
or from a YAML/JSON file + CLI overrides via utils.configurate.parse_config.
`to_train_config()` bridges onto the trainer (training/strategies.py); as
in the JAX package it does not pass `unfreeze_last_llm_layer` on, so the
`*-last_layer` and `*-sandwich` variants train what their two freeze flags
say and no last layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils.configurate import ChoiceRegistry
from .strategies import TrainConfig


@dataclass(frozen=True)
class VLARunConfig(ChoiceRegistry):
    vla_id: str = "siglip-224px+mx-bridge"
    base_vlm: str = "siglip-224px+7b"

    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = False
    unfreeze_last_llm_layer: bool = False

    data_mix: str = "bridge"
    shuffle_buffer_size: int = 256_000

    epochs: int = 1000
    max_steps: Optional[int] = None

    expected_world_size: int = 8
    global_batch_size: int = 256
    per_device_batch_size: int = 32

    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0

    train_strategy: str = "fsdp-full-shard"
    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = True

    @property
    def grad_accumulation_steps(self) -> int:
        """Auto-computed like the reference (conf/vla.py:41-43 contract)."""
        per_step = self.per_device_batch_size * self.expected_world_size
        return max(1, self.global_batch_size // per_step)

    def to_train_config(self, max_steps: Optional[int] = None) -> TrainConfig:
        return TrainConfig(
            strategy="fsdp" if self.train_strategy.startswith("fsdp") else "ddp",
            learning_rate=self.learning_rate,
            weight_decay=self.weight_decay,
            max_grad_norm=self.max_grad_norm,
            warmup_ratio=self.warmup_ratio,
            max_steps=max_steps or self.max_steps or 1000,
            grad_accumulation_steps=self.grad_accumulation_steps,
            freeze_vision_backbone=self.freeze_vision_backbone,
            freeze_llm_backbone=self.freeze_llm_backbone,
        )


def _register_variant(root_cls: type, name: str, base) -> None:
    """Register `base`'s field values as a (trivially constructed) subclass
    of `root_cls` so the registry round-trips through config files like the
    reference's per-experiment dataclasses."""
    cls_name = f"{root_cls.__name__}_{name}".replace("+", "_").replace("-", "_")
    cls = type(cls_name, (root_cls,), {})
    cls.__init__ = lambda self, **kw: root_cls.__init__(  # type: ignore[method-assign]
        self, **{**base.__dict__, **kw}
    )
    root_cls.register_subclass(name, cls)


def _variant(vla_id: str, **over) -> None:
    _register_variant(VLARunConfig, vla_id, VLARunConfig(vla_id=vla_id, **over))


# === reference experiment registry (conf/vla.py:64-235) ===
_variant("siglip-224px+mx-bridge")
_variant("siglip-224px-icy+mx-bridge", freeze_vision_backbone=True)
_variant("prism-dinosiglip-224px+mx-bridge", base_vlm="prism-dinosiglip-224px+7b")
_variant("siglip-224px+mx-oxe-magic-soup", data_mix="oxe_magic_soup",
         expected_world_size=64, global_batch_size=2048)
# two-stage schedule in the reference: 70% on soup++ incl. DROID, then
# resampled — registered with the resampled mixture like conf/vla.py:130-132
_variant("prism-dinosiglip-224px+mx-oxe-magic-soup-plus",
         base_vlm="prism-dinosiglip-224px+7b", data_mix="oxe_magic_soup_plus_minus",
         expected_world_size=64, global_batch_size=2048)
for _task in ("tdroid_carrot_in_bowl", "tdroid_pour_corn_in_pot"):
    _variant(f"siglip-224px+mx-{_task}", data_mix=_task)
_variant("siglip-224px-icy+mx-tdroid_carrot_in_bowl",
         data_mix="tdroid_carrot_in_bowl", freeze_vision_backbone=True)
_variant("siglip-224px-last_layer+mx-tdroid_carrot_in_bowl",
         data_mix="tdroid_carrot_in_bowl", freeze_vision_backbone=True,
         freeze_llm_backbone=True, unfreeze_last_llm_layer=True)
_variant("siglip-224px-sandwich+mx-tdroid_carrot_in_bowl",
         data_mix="tdroid_carrot_in_bowl", freeze_llm_backbone=True,
         unfreeze_last_llm_layer=True)
_variant("siglip-224px+mx-droid_wipe", data_mix="droid_wipe")


# === VLM-pretrain dataset registry (conf/datasets.py:20-133) ===

@dataclass(frozen=True)
class DatasetConfig(ChoiceRegistry):
    """LLaVA pretrain dataset variant: per-stage (annotations, images)
    component paths relative to `dataset_root_dir`. Paths and IDs are the
    reference's constants; the align stage shares one source across variants,
    the finetune stage selects the instruct mix."""
    dataset_id: str = "llava-v15"
    align_stage_components: tuple = (
        "download/llava-laion-cc-sbu-558k/chat.json",
        "download/llava-laion-cc-sbu-558k/",
    )
    finetune_stage_components: tuple = (
        "download/llava-v1.5-instruct/llava_v1_5_mix665k.json",
        "download/llava-v1.5-instruct/",
    )
    dataset_root_dir: str = "datasets/prismatic-vlms"


def _dataset_variant(dataset_id: str, finetune_json: str) -> None:
    _register_variant(DatasetConfig, dataset_id, DatasetConfig(
        dataset_id=dataset_id,
        finetune_stage_components=(
            f"download/llava-v1.5-instruct/{finetune_json}",
            "download/llava-v1.5-instruct/",
        ),
    ))


_dataset_variant("llava-v15", "llava_v1_5_mix665k.json")
_dataset_variant("llava-multimodal", "llava_v1_5_stripped625k.json")
_dataset_variant("llava-lvis4v", "llava_v1_5_lvis4v_mix888k.json")
_dataset_variant("llava-lrv", "llava_v1_5_lrv_mix1008k.json")
_dataset_variant("llava-lvis4v-lrv", "llava_v1_5_lvis4v_lrv_mix1231k.json")
