"""VLA policy for serving and closed-loop evaluation, in PyTorch.

`VLAPolicy.get_action` collapses the OpenVLA `get_model` / `get_action`
stack into one object: frame -> prompt -> processor -> greedy decode on the
device -> unnormalized 7-DoF action. Env-side gripper sign conventions stay
with the caller.

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
GPU and without that explicit choice they raise. They never fall back to
the CPU on their own.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.config import VLAConfig, get_config, torch_dtype
from ..models.decode import (
    KV_CACHE_MODES,
    DecodeResult,
    decode_layout_params,
    ensure_trailing_empty_token,
    greedy_decode_actions,
    unnormalize_actions,
)
from ..models.vlm import VLA
from ..utils.constants import ACTION_DIM, PAD_TOKEN_ID
from ..utils.device import resolve_device
from ..utils.normalization import dual_normalize
from ..utils.prompting import TextTokenizer, tokenizer_from_checkpoint
from ..utils.quant_args import parse_quantize, resolve_quantize
from .processing import center_crop_resize_tf, eval_prompt, resize_bicubic_pil

PROMPT_PAD = 64
# the decode options a policy holds and `VLAPolicy.decode` can override per call
DECODE_OPTIONS = ("kv_cache", "visual_tokens", "act_quant", "int4_kernel")


def _to_device(tree: Mapping, device: torch.device) -> Dict:
    return {
        k: _to_device(v, device) if isinstance(v, Mapping) else v.to(device)
        for k, v in tree.items()
    }


class VLAPolicy:
    def __init__(
        self,
        params,
        cfg: VLAConfig,
        tokenizer: TextTokenizer,
        norm_stats: Dict,
        unnorm_key: Optional[str] = None,
        center_crop: bool = False,
        prompt_pad: int = PROMPT_PAD,
        cooked_weights: bool = False,
        quantize: Optional[str] = None,
        kv_cache: Optional[str] = None,
        visual_tokens: Optional[int] = None,
        int4_kernel: Optional[bool] = None,
        device="cuda",
    ) -> None:
        """`params`: a `VLA` module (models.bridge.params_from_jax gives one)
        or the nested dict of tensors in the JAX pytree layout.

        `quantize='int8'|'int4'|'int4:<gs>'`: weight-only quantization of the
        LLM stack + lm_head/embed (models/quant.py); `'w8a8'`: int8 weights
        plus per-token int8 activations in the prefill's projections (the
        tail stays weight-only). `int4_kernel=None` resolves to "int4
        weights and a CUDA device": the decode tail's projections then run
        the CUDA dequant-matmul kernel.

        `kv_cache='int8'|'int4'` and `visual_tokens=k` reach every decode
        (models/decode.py greedy_decode_actions). `center_crop=True` crops
        each frame to 0.9 of its area and resizes it back to 224 before the
        processor (the reference's eval-time crop, eval/processing.py)."""
        self.device = resolve_device(device)
        quant_mode, act_quant, quant_gs = resolve_quantize(quantize)
        if kv_cache not in KV_CACHE_MODES:
            raise ValueError(f"kv_cache={kv_cache!r}; supported: None, 'int8', 'int4'")
        self.kv_cache, self.visual_tokens, self.act_quant = kv_cache, visual_tokens, act_quant
        if int4_kernel is None:
            int4_kernel = quant_mode == "int4" and self.device.type == "cuda"
        self.int4_kernel = bool(int4_kernel)
        if self.int4_kernel and quant_mode == "int4" and self.device.type == "cuda":
            from ..models.quant import int4_group_size_for
            from ..ops.q4_matmul import KERNEL_GROUP_SIZES

            if torch_dtype(cfg) != torch.bfloat16:
                raise ValueError(
                    f"the CUDA int4 kernel takes bf16 activations and {cfg.name!r} "
                    f"runs in {cfg.dtype}; pass int4_kernel=False (--int4_kernel off)"
                )
            if quant_gs is None:
                quant_gs = int4_group_size_for(cfg)
            if quant_gs not in KERNEL_GROUP_SIZES:
                raise ValueError(
                    f"the CUDA int4 kernel takes groups of {KERNEL_GROUP_SIZES} "
                    f"channels and quantize={quantize!r} gives {cfg.name!r} groups "
                    f"of {quant_gs}; pass int4_kernel=False (--int4_kernel off)"
                )

        tree = params.tree() if isinstance(params, nn.Module) else params
        del params
        # The JAX package cooks and quantizes on the host because one TPU v5e
        # holds 15.75 GB. An 80 GB card has room to init, cook and quantize
        # the 7B on the device, one stack at a time (models/quant.py works
        # one layer of one stack at a time, so its f32 transients stay small).
        tree = _to_device(tree, self.device)
        if not cooked_weights:
            tree = decode_layout_params(tree)
        if quant_mode is not None:
            from ..models.quant import int4_group_size_for, quantize_decode_params

            if quant_gs is None:
                quant_gs = int4_group_size_for(cfg)
            tree = quantize_decode_params(tree, mode=quant_mode, group_size=quant_gs)
        self.model = VLA(cfg, tree).eval()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.norm_stats = norm_stats
        self.unnorm_key = unnorm_key
        self.center_crop = center_crop
        self.prompt_pad = prompt_pad
        self._prompt_cache: Dict[str, tuple] = {}
        # [N, 7] token ids of the most recent get_action_multi call: the
        # draft that draft_tokens="last" sends with the next call
        self.last_tokens: Optional[np.ndarray] = None
        # Jacobi verification passes of the most recent decode (None after a
        # sequential one; 1 = the draft was accepted whole)
        self.last_verify_passes: Optional[int] = None

    @property
    def vocab_size(self) -> int:
        """Rows of the embedding: a token id (a draft's too) lies below it."""
        return self.cfg.llm.vocab_size

    def _tokenize(self, task_label: str):
        key = task_label
        if key not in self._prompt_cache:
            ids = np.asarray(self.tokenizer.encode(eval_prompt(task_label), add_bos=True), np.int32)
            row = np.full((1, self.prompt_pad), PAD_TOKEN_ID, np.int32)
            mask = np.zeros((1, self.prompt_pad), np.int32)
            row[0, : len(ids)] = ids
            mask[0, : len(ids)] = 1
            row, mask = ensure_trailing_empty_token(row, mask)
            # ensure() grows the row by one; drop the excess column only if
            # it is padding, or a prompt that exactly fills prompt_pad would
            # silently lose the required 29871
            if mask[:, self.prompt_pad :].any():
                raise ValueError(
                    f"prompt for task '{task_label}' needs "
                    f"{int(mask.sum())} tokens (incl. trailing 29871) but "
                    f"prompt_pad={self.prompt_pad}; raise prompt_pad"
                )
            row, mask = row[:, : self.prompt_pad], mask[:, : self.prompt_pad]
            self._prompt_cache[key] = (row, mask)
        return self._prompt_cache[key]

    def prepare(self, images_u8: np.ndarray, task_labels: Sequence[str]):
        """Model inputs on the device for [N, H, W, 3] uint8 frames with a
        task label per row: (input_ids, attention_mask, pixel_values)."""
        if len(task_labels) != len(images_u8):
            raise ValueError(
                f"{len(images_u8)} images vs {len(task_labels)} task labels"
            )
        size = self.cfg.dino.image_size
        frames = []
        for img in images_u8:
            if self.center_crop:  # the eval-time crop 0.9, back to 224 (TF's crop_and_resize)
                img = center_crop_resize_tf(img, crop_scale=0.9)
            frames.append(img if img.shape[:2] == (size, size) else resize_bicubic_pil(img, size))
        pixels = torch.from_numpy(np.stack(frames)).to(self.device).float() / 255.0
        pixels = dual_normalize(pixels).to(torch_dtype(self.cfg))
        rows = [self._tokenize(t) for t in task_labels]
        ids = torch.from_numpy(np.concatenate([r[0] for r in rows], axis=0)).to(self.device)
        mask = torch.from_numpy(np.concatenate([r[1] for r in rows], axis=0)).to(self.device)
        return ids, mask, pixels

    def decode(self, images_u8: np.ndarray, task_labels: Sequence[str], draft_tokens=None,
               **options) -> DecodeResult:
        """One greedy decode of a mixed-task batch -> the DecodeResult
        (tokens, normalized actions, logits or verify passes) on the
        policy's device. `draft_tokens` [N, 7] runs the Jacobi tail;
        `options` (DECODE_OPTIONS) override the policy's own for this call."""
        return self.decode_inputs(self.prepare(images_u8, task_labels), draft_tokens, **options)

    def decode_inputs(self, inputs, draft_tokens=None, num_steps: int = ACTION_DIM,
                      **options) -> DecodeResult:
        """`decode` on the (input_ids, attention_mask, pixel_values) that
        `prepare` gave, so a caller can time the decode alone; `num_steps`
        below 7 cuts the tail (1 = the prefill alone)."""
        unknown = set(options) - set(DECODE_OPTIONS)
        if unknown:
            raise TypeError(f"unknown decode options {sorted(unknown)}; known: {DECODE_OPTIONS}")
        opts = {k: options.get(k, getattr(self, k)) for k in DECODE_OPTIONS}
        ids, mask, pixels = inputs
        if draft_tokens is not None:
            draft_tokens = torch.as_tensor(draft_tokens, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return greedy_decode_actions(
                self.model.tree(), self.cfg, ids, mask, pixels, num_steps=num_steps,
                cooked_weights=True, draft_tokens=draft_tokens, **opts,
            )

    def get_action(self, image_u8: np.ndarray, task_label: str, draft_tokens=None) -> np.ndarray:
        """image_u8: uint8 [H, W, 3] frame -> the unnormalized 7-DoF action.
        `draft_tokens`: a [7] token array or "last" (get_action_multi)."""
        if draft_tokens is not None and not isinstance(draft_tokens, str):
            draft_tokens = np.asarray(draft_tokens, np.int32).reshape(1, -1)
        return self.get_action_multi(image_u8[None], [task_label], draft_tokens=draft_tokens)[0]

    def get_action_batch(self, images_u8: np.ndarray, task_label: str, draft_tokens=None) -> np.ndarray:
        """Lockstep multi-environment rollouts: [N, H, W, 3] uint8 frames,
        one task -> [N, 7] unnormalized actions from one decode."""
        return self.get_action_multi(
            images_u8, [task_label] * len(images_u8), draft_tokens=draft_tokens
        )

    def get_action_multi(
        self,
        images_u8: np.ndarray,
        task_labels: Sequence[str],
        draft_tokens=None,
    ) -> np.ndarray:
        """Mixed-task batched inference: [N, H, W, 3] uint8 frames with a task
        label per row -> [N, 7] unnormalized actions from one decode (the
        coalescing primitive serving.DynamicBatcher builds on).

        `draft_tokens`: [N, 7] token ids, or "last" for the previous call's
        tokens, switch the tail to Jacobi verification passes (exact
        greedy; a correct draft verifies in one pass). "last" on a cold
        start or after a change of batch width gives a zero draft."""
        if isinstance(draft_tokens, str):
            if draft_tokens != "last":
                raise ValueError(f"draft_tokens={draft_tokens!r}; use 'last' or an [N, 7] token array")
            draft_tokens = (
                self.last_tokens
                if self.last_tokens is not None and self.last_tokens.shape[0] == len(images_u8)
                else np.zeros((len(images_u8), 7), np.int32)
            )
        res = self.decode(images_u8, task_labels, draft_tokens=draft_tokens)
        self.last_verify_passes = res.verify_passes
        self.last_tokens = res.tokens.cpu().numpy()
        normalized = res.actions.cpu().numpy().astype(np.float64)
        return np.stack([
            unnormalize_actions(a, self.norm_stats, self.unnorm_key) for a in normalized
        ])


def load_policy(
    checkpoint: Optional[str] = None,
    model_name: str = "openvla-7b",
    unnorm_key: Optional[str] = None,
    center_crop: bool = False,
    seed: int = 42,
    quantize: Optional[str] = None,
    kv_cache: Optional[str] = None,
    visual_tokens: Optional[int] = None,
    int4_kernel: Optional[bool] = None,
    device="cuda",
) -> VLAPolicy:
    """A policy on `device` from a local HF checkpoint directory: its
    weights converted on the device and cast to the config's dtype, its
    dataset statistics and its tokenizer (WordStubTokenizer when it ships
    none). Without a checkpoint, random weights drawn from `seed`. A missing
    directory, shard or tensor raises; nothing falls back to random weights."""
    parse_quantize(quantize)  # reject a typo'd mode before the 15 GB load
    dev = resolve_device(device)
    cfg = get_config(model_name)
    if checkpoint:
        from ..models.convert import cast_tree, load_checkpoint_dir, load_norm_stats

        params = cast_tree(load_checkpoint_dir(checkpoint, cfg, dev), torch_dtype(cfg))
        norm_stats = load_norm_stats(checkpoint)
        tokenizer = tokenizer_from_checkpoint(checkpoint)
    else:
        from ..models.vlm import init_vla_params

        tokenizer = tokenizer_from_checkpoint(None)
        params = init_vla_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        norm_stats = {
            "synthetic": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7,
                                      "mask": [True] * 6 + [False]}}
        }
        unnorm_key = unnorm_key or "synthetic"
    return VLAPolicy(
        params, cfg, tokenizer, norm_stats, unnorm_key, center_crop, quantize=quantize,
        kv_cache=kv_cache, visual_tokens=visual_tokens, int4_kernel=int4_kernel, device=dev,
    )


# --- the reference's dispatch shims (experiments/robot/robot_utils.py:40-74) ---

def get_model(cfg_or_checkpoint, model_family: str = "openvla", **kwargs) -> VLAPolicy:
    """`get_model`: a checkpoint path (or a config object with
    `.pretrained_checkpoint`) -> a loaded policy."""
    checkpoint = getattr(cfg_or_checkpoint, "pretrained_checkpoint", cfg_or_checkpoint)
    if model_family != "openvla":
        raise ValueError(f"unsupported model family {model_family!r}")
    return load_policy(checkpoint, **kwargs)


def get_action(policy: VLAPolicy, obs: Dict, task_label: str,
               model_family: str = "openvla") -> np.ndarray:
    """`get_action`: an obs dict with 'full_image' -> the 7-DoF action."""
    if model_family != "openvla":
        raise ValueError(f"unsupported model family {model_family!r}")
    return policy.get_action(obs["full_image"], task_label)
