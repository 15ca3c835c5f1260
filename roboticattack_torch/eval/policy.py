"""VLA policy for serving and closed-loop evaluation, in PyTorch.

`VLAPolicy.get_action` collapses the OpenVLA `get_model` / `get_action`
stack into one object: frame -> prompt -> processor -> greedy decode on the
device -> unnormalized 7-DoF action. Env-side gripper sign conventions stay
with the caller.

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
GPU and without that explicit choice they raise. They never fall back to
the CPU on their own.

`mesh=` (parallel.make_serving_mesh) serves a dp x tp grid of torchrun
ranks: each rank holds its Megatron shard of the cooked, quantized tree
(parallel/sharding.py), cut leaf by leaf as the weights are drawn or read;
rank 0 drives every decode and the others follow it (serving/ranks.py).
"""

from __future__ import annotations

import collections
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.config import DeepseekV3Config, VLAConfig, get_config, torch_dtype
from ..models.deepseek import unsupported
from ..models.decode import (
    KV_CACHE_MODES,
    DecodeResult,
    ensure_trailing_empty_token,
    greedy_decode_actions,
    unnormalize_actions,
)
from ..models.vlm import VLA
from ..ops.q4_matmul import KERNEL_GROUP_SIZES
from ..utils.constants import ACTION_DIM, PAD_TOKEN_ID
from ..utils.device import resolve_device
from ..utils.normalization import dual_normalize
from ..utils.prompting import TextTokenizer, tokenizer_from_checkpoint
from ..utils.quant_args import parse_quantize, resolve_quantize
from .processing import center_crop_resize_tf, eval_prompt, resize_bicubic_pil

PROMPT_PAD = 64
# the decode options a policy holds and `VLAPolicy.decode` can override per call
DECODE_OPTIONS = ("kv_cache", "visual_tokens", "act_quant", "int4_kernel")


def _to_device(leaves, device: torch.device):
    """(path, leaf on `device`) of `leaves`, one at a time: none is kept
    once it is handed over."""
    for path, x in leaves:
        x = x.to(device)
        yield path, x
        del x


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
        mesh=None,
    ) -> None:
        """`params`: a `VLA` module (models.bridge.params_from_jax gives one)
        or the nested dict of tensors in the JAX pytree layout, or an
        iterable of its (path, tensor) leaves (models.vlm.iter_vla_params,
        models.convert.iter_checkpoint_leaves), consumed one at a time.

        `quantize='int8'|'int4'|'int4:<gs>'`: weight-only quantization of the
        LLM stack + lm_head/embed (models/quant.py); `'w8a8'`: int8 weights
        plus per-token int8 activations in the prefill's projections (the
        tail stays weight-only). `int4_kernel=None` resolves to "int4
        weights, a CUDA device, a bf16 model and a group of 32 * 2^k
        channels (ops.q4_matmul.KERNEL_GROUP_SIZES)": the decode tail's
        projections then run the CUDA dequant-matmul kernel, and anywhere
        else the decode's own int4 branch, as the JAX package's default
        does where its kernel is not engaged. An explicit True that the
        kernel cannot take raises ValueError before any weight moves.

        `kv_cache='int8'|'int4'` and `visual_tokens=k` reach every decode
        (models/decode.py greedy_decode_actions). `center_crop=True` crops
        each frame to 0.9 of its area and resizes it back to 224 before the
        processor (the reference's eval-time crop, eval/processing.py).

        `mesh` (a ServingMesh): the policy holds this rank's shard (the int4
        group size then divides each rank's row-parallel contraction,
        int4_group_size_for(cfg, tp)), `decode` runs on every rank of the
        world, and rank 0 gets the whole batch's results (serving/ranks.py).
        With int4 on CUDA the kernel runs on each rank's local stacks."""
        if isinstance(cfg.llm, DeepseekV3Config):
            raise unsupported(f"serving ({cfg.name!r}: the policy's decode has no latent-attention cache)")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks are on {mesh.device}, the policy asks for {self.device}")
        if mesh is not None:
            self.device = mesh.device
        quant_mode, act_quant, quant_gs = resolve_quantize(quantize)
        if quant_mode == "int4" and quant_gs is None:
            from ..models.quant import int4_group_size_for

            quant_gs = int4_group_size_for(cfg, tp=mesh.tp if mesh is not None else 1)
        if kv_cache not in KV_CACHE_MODES:
            raise ValueError(f"kv_cache={kv_cache!r}; supported: None, 'int8', 'int4'")
        self.kv_cache, self.visual_tokens, self.act_quant = kv_cache, visual_tokens, act_quant
        if int4_kernel is None:  # the kernel where it can run; elsewhere the decode's own int4 branch
            int4_kernel = (quant_mode == "int4" and self.device.type == "cuda"
                           and torch_dtype(cfg) == torch.bfloat16 and quant_gs in KERNEL_GROUP_SIZES)
        self.int4_kernel = bool(int4_kernel)
        if self.int4_kernel and quant_mode == "int4" and self.device.type == "cuda":
            if torch_dtype(cfg) != torch.bfloat16:
                raise ValueError(
                    f"the CUDA int4 kernel takes bf16 activations and {cfg.name!r} "
                    f"runs in {cfg.dtype}; pass int4_kernel=False (--int4_kernel off)"
                )
            if quant_gs not in KERNEL_GROUP_SIZES:
                raise ValueError(
                    f"the CUDA int4 kernel takes groups of {KERNEL_GROUP_SIZES} "
                    f"channels and quantize={quantize!r} gives {cfg.name!r} groups "
                    f"of {quant_gs}; pass int4_kernel=False (--int4_kernel off)"
                )

        tree = params.tree() if isinstance(params, nn.Module) else params
        del params
        # The JAX package cooks and quantizes on the host because one TPU v5e
        # holds 15.75 GB. Here each leaf is moved to the device, then cooked,
        # quantized (one layer at a time, so the f32 transients stay small)
        # and cut, before the next one comes: a single process is a mesh of
        # one rank that keeps every leaf whole.
        self.load_peak_gib = self.load_held_gib = None
        tree = self._load(tree, cfg, mesh, cooked_weights, quant_mode, quant_gs)
        self.mesh = mesh
        self._dp_warned: set = set()
        # under a mesh: the last 1024 decodes' rows, wall ms and B4 launches
        self.decode_log = collections.deque(maxlen=1024)
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

    def _load(self, tree, cfg, mesh, cooked_weights: bool, quant_mode, quant_gs) -> Dict:
        """This rank's cooked and quantized tree (the whole tree without a
        mesh), built one leaf at a time (parallel.sharding.
        shard_decode_leaves). Under a mesh on CUDA, the load's peak and what
        it keeps are recorded (`load_peak_gib`, `load_held_gib`) and the
        process's peak starts again after it."""
        from ..models.config import PhiConfig
        from ..models.param_tree import tree_leaves
        from ..models.quant import quant_mode as tree_quant_mode
        from ..parallel.mesh import ServingMesh
        from ..parallel.sharding import shard_decode_leaves

        if quant_mode is not None and isinstance(cfg.llm, PhiConfig):
            raise ValueError("int8/int4 decode quantization supports Llama-family layer stacks "
                             f"(gate/up/down SwiGLU); {cfg.name!r} has a Phi LLM")
        if isinstance(tree, Mapping):
            have = tree_quant_mode(tree)
            if have is not None:  # cut as it is, as quantize_decode_params returns it
                if not cooked_weights:
                    raise ValueError(
                        "params are already int8/int4-quantized (quantize_decode_params output, which "
                        "implies the cooked layout); cooking again would transpose the quantized stacks "
                        "away from their scales")
                if quant_mode not in (None, have):
                    raise ValueError(f"params are already {have}-quantized; re-quantizing to {quant_mode} "
                                     "would compound rounding")
                quant_mode = None
            tree = tree_leaves(tree)
        rank_mesh = mesh or ServingMesh(tp=1, dp=1, rank=0, device=self.device)
        out = shard_decode_leaves(_to_device(tree, self.device), rank_mesh, cooked=cooked_weights, quant=quant_mode,
                                  group_size=quant_gs)
        if mesh is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.load_peak_gib = torch.cuda.max_memory_allocated(self.device) / 2**30
            self.load_held_gib = torch.cuda.memory_allocated(self.device) / 2**30
            torch.cuda.reset_peak_memory_stats(self.device)
        return out

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
        if self.mesh is not None:
            from ..serving import ranks

            if self.mesh.rank != 0:
                raise RuntimeError(f"rank {self.mesh.rank} follows rank 0's decodes (serving.ranks.follow)")
            if self.mesh.world > 1:
                return ranks.lead(self, (ids, mask, pixels), draft_tokens, num_steps, opts)
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
    mesh=None,
) -> VLAPolicy:
    """A policy on `device` from a local HF checkpoint directory: its
    weights converted on the device and cast to the config's dtype, its
    dataset statistics and its tokenizer (WordStubTokenizer when it ships
    none). Without a checkpoint, random weights drawn from `seed`. A missing
    directory, shard or tensor raises; nothing falls back to random weights.
    The weights are read (or drawn) one leaf at a time and each is cooked
    and quantized before the next (VLAPolicy).

    `mesh` (a ServingMesh): every rank reads (or draws, from the same
    generator in the same order) every leaf on its own device and keeps its
    shard of it."""
    parse_quantize(quantize)  # reject a typo'd mode before the 15 GB load
    dev = mesh.device if mesh is not None else resolve_device(device)
    cfg = get_config(model_name)
    if checkpoint:
        from ..models.convert import iter_checkpoint_leaves, load_norm_stats

        params = iter_checkpoint_leaves(checkpoint, cfg, dev, torch_dtype(cfg))
        norm_stats = load_norm_stats(checkpoint)
        tokenizer = tokenizer_from_checkpoint(checkpoint)
    else:
        from ..models.vlm import iter_vla_params

        tokenizer = tokenizer_from_checkpoint(None)
        params = iter_vla_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        norm_stats = {
            "synthetic": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7,
                                      "mask": [True] * 6 + [False]}}
        }
        unnorm_key = unnorm_key or "synthetic"
    return VLAPolicy(
        params, cfg, tokenizer, norm_stats, unnorm_key, center_crop, quantize=quantize,
        kv_cache=kv_cache, visual_tokens=visual_tokens, int4_kernel=int4_kernel, device=dev, mesh=mesh,
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


def set_seed_everywhere(seed: int) -> None:
    """robot_utils.py:29-37: Python's, numpy's and torch's global generators
    (torch.manual_seed seeds every device's)."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
