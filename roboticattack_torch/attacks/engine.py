"""The attack step: the framework's hot path (the JAX package's
`attacks/engine.py`).

One call = one outer iteration: `inner_loop` rounds of re-randomized patch
placement/affine -> dual normalize -> frozen-VLM forward and backward with
respect to the patch pixels only -> AdamW/PGD update -> clamp to [0, 1].
`lax.scan` over the inner steps becomes a Python loop, `jax.value_and_grad`
over the patch `torch.autograd.grad` over a patch tensor that requires grad
(the weights never do). The step runs on the device of its tensors.

The random draws are an argument (`StepDraws`): per inner step the batch's
placements and matrices (ops/patch_ops.py `PatchDraws`), and the coin of
`change_target` for `upa_guide`. `draw_step` draws them from a
`torch.Generator`; the tests replay the JAX package's draws instead.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import VLAConfig, torch_dtype
from ..models.vlm import vla_forward
from ..ops.patch_ops import PatchDraws, apply_patch_batch, draw_patch_params
from ..utils.action_tokenizer import decode_tokens
from ..utils.constants import ACTION_TOKEN_ZERO
from ..utils.labels import change_target, draw_coin, mask_labels, overwrite_with_target
from ..utils.normalization import dual_normalize
from .losses import (
    action_preds_and_mask,
    clip_grad_l1,
    per_dim_relative_distance,
    per_example_metrics,
    tma_metrics,
    uada_loss,
    upa_loss,
)
from .optimizer import AdamState, adam_init, adamw_update, pgd_update


class AttackBatch(NamedTuple):
    """One data batch. images are raw [B, H, W, 3] float32 in [0, 1]:
    patching happens before normalization."""

    images: torch.Tensor
    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    labels: torch.Tensor


class AttackState(NamedTuple):
    patch: torch.Tensor         # [ph, pw, 3] float32 in [0, 1]
    opt: AdamState
    grad_acc: torch.Tensor      # accumulation buffer


class AttackSpec(NamedTuple):
    """Static attack configuration."""

    objective: str = "tma"          # tma | uada | upa | upa_guide | upa_negce
    geometry: bool = True
    resize_patch: bool = False
    inner_loop: int = 50
    accumulate_steps: int = 1
    optimizer: str = "adamW"        # adamW | pgd
    pgd_alpha: float = 2e-3
    mse_weight: float = 5.0
    add_inverse_ce: bool = True
    upa_alpha: float = 0.8
    upa_beta: float = 0.2
    grad_clip_l1: Optional[float] = None


class StepDraws(NamedTuple):
    """The draws of one outer step: one `PatchDraws` per inner step, and the
    `change_target` coin (labels' shape, bool) for upa_guide, else None."""

    inner: Sequence[PatchDraws]
    coin: Optional[torch.Tensor] = None


def batch_to_device(batch, device) -> AttackBatch:
    """A numpy batch (data/collator.py) -> tensors on `device`: f32 images,
    int64 ids, mask and labels."""
    images, ids, mask, labels = (torch.as_tensor(np.asarray(a)) for a in batch)
    return AttackBatch(images=images.float().to(device), input_ids=ids.long().to(device),
                       attention_mask=mask.long().to(device), labels=labels.long().to(device))


def init_attack_state(gen: Optional[torch.Generator], patch_hw: Tuple[int, int], device) -> AttackState:
    """patch ~ U[0, 1), drawn on the CPU from `gen`, then moved to `device`."""
    patch = torch.rand((patch_hw[0], patch_hw[1], 3), generator=gen).to(device)
    return AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch))


def draw_step(gen: Optional[torch.Generator], spec: AttackSpec, images_shape, patch_hw,
              labels_shape, inner: Optional[int] = None) -> StepDraws:
    """An outer step's draws from `gen` on the CPU: the coin (upa_guide
    only), then each inner step's patch draws."""
    b, h, w = images_shape[:3]
    coin = draw_coin(labels_shape, gen) if spec.objective == "upa_guide" else None
    n = spec.inner_loop if inner is None else inner
    return StepDraws(
        inner=[draw_patch_params(gen, b, h, w, patch_hw[0], patch_hw[1], spec.resize_patch)
               for _ in range(n)],
        coin=coin,
    )


def _objective_loss(spec: AttackSpec, cfg: VLAConfig, out, labels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    ce = out.loss
    if spec.objective == "tma":
        m = tma_metrics(out.logits, labels, ce, cfg)
        return ce, {"ce": ce, "l1": m.l1, "asr": m.asr, "rel_dist": m.relative_distance}
    if spec.objective == "uada":
        r = uada_loss(out.logits, labels, ce, cfg, mse_weight=spec.mse_weight,
                      add_inverse_ce=spec.add_inverse_ce)
        return r.loss, {"ce": ce, "mse_distance": r.mse_distance, "uad": r.uad}
    if spec.objective == "upa":
        r = upa_loss(out.logits, labels, ce, cfg, alpha=spec.upa_alpha, beta=spec.upa_beta)
        return r.loss, {"ce": ce, "angle": r.angle_loss, "distance": r.distance_loss}
    if spec.objective == "upa_guide":
        return ce, {"ce": ce}
    if spec.objective == "upa_negce":
        return -ce, {"ce": ce}
    raise ValueError(f"unknown objective {spec.objective}")


def prepare_labels(spec: AttackSpec, labels, target, maskidx, coin):
    """The objective's labels: TMA's target overwrite, UADA / negce masking,
    guide-mode flips (with `coin`), or the raw labels (UPA reverse)."""
    if spec.objective == "tma":
        return overwrite_with_target(labels, target)
    if spec.objective in ("uada", "upa_negce"):
        return mask_labels(labels, maskidx)
    if spec.objective == "upa_guide":
        # mask_labels before change_target: only the maskidx dims (+ EOS)
        # get flipped targets
        return change_target(mask_labels(labels, maskidx), coin)
    return labels  # upa reverse direction keeps the raw labels


def patch_loss_and_grad(spec: AttackSpec, cfg: VLAConfig, params: Dict, patch: torch.Tensor,
                        batch: AttackBatch, labels, draws: PatchDraws):
    """The objective of one inner step and its gradient with respect to the
    patch pixels alone: (loss, metrics, grad)."""
    patch = patch.detach().requires_grad_(True)
    with torch.enable_grad():
        patched = apply_patch_batch(batch.images, patch, draws, geometry=spec.geometry,
                                    resize_patch=spec.resize_patch)
        pixels = dual_normalize(patched).to(torch_dtype(cfg))
        out = vla_forward(params, cfg, batch.input_ids, batch.attention_mask, pixels, labels)
        loss, metrics = _objective_loss(spec, cfg, out, labels)
        if spec.objective == "tma":
            loss = loss / spec.accumulate_steps
        (grad,) = torch.autograd.grad(loss, patch)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad


def _inner_step(spec: AttackSpec, cfg: VLAConfig, params: Dict, state: AttackState,
                batch: AttackBatch, labels, lr, apply_update: bool,
                draws: PatchDraws) -> Tuple[AttackState, Dict[str, torch.Tensor]]:
    loss, metrics, grad = patch_loss_and_grad(spec, cfg, params, state.patch, batch, labels, draws)
    metrics.update(loss=loss, grad_mean=grad.mean())

    grad_total = state.grad_acc + grad
    if not apply_update:
        # accumulation: the patch and optimizer wait, the buffer keeps the
        # raw gradients
        return AttackState(patch=state.patch, opt=state.opt, grad_acc=grad_total), metrics
    # clip only at update time; clipping the running buffer each inner step
    # would rescale earlier contributions again and again
    update_grad = grad_total
    if spec.grad_clip_l1 is not None:
        update_grad = clip_grad_l1(grad_total, spec.grad_clip_l1)
    if spec.optimizer == "adamW":
        new_patch, opt = adamw_update(update_grad, state.opt, state.patch, lr)
    elif spec.optimizer == "pgd":
        new_patch, opt = pgd_update(update_grad, state.patch, spec.pgd_alpha), state.opt
    else:
        raise ValueError(f"unknown optimizer {spec.optimizer}")
    return AttackState(patch=new_patch.clamp(0.0, 1.0), opt=opt,
                       grad_acc=torch.zeros_like(grad_total)), metrics


def target_tensor(target_tokens, device):
    return None if target_tokens is None else torch.as_tensor(np.asarray(target_tokens), device=device)


def make_attack_step(spec: AttackSpec, cfg: VLAConfig, target_tokens: Optional[np.ndarray],
                     maskidx: Sequence[int]):
    """step(params, state, batch, lr, apply_update, draws) -> (state,
    metrics), each metric stacked over the inner steps ([inner_loop])."""
    maskidx = tuple(maskidx)

    def step(params: Dict, state: AttackState, batch: AttackBatch, lr: float,
             apply_update: bool, draws: StepDraws):
        if len(draws.inner) != spec.inner_loop:
            raise ValueError(f"{len(draws.inner)} inner draws for inner_loop={spec.inner_loop}")
        dev = batch.images.device
        labels = prepare_labels(spec, batch.labels, target_tensor(target_tokens, dev), maskidx, draws.coin)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        history: List[Dict[str, torch.Tensor]] = []
        for d in draws.inner:
            state, metrics = _inner_step(spec, cfg, params, state, batch, labels, lr_t,
                                         bool(apply_update), d)
            history.append(metrics)
        return state, {k: torch.stack([h[k] for h in history]) for k in history[0]}

    return step


def make_val_step(spec: AttackSpec, cfg: VLAConfig, target_tokens: Optional[np.ndarray],
                  maskidx: Sequence[int]):
    """No-grad scorer of the eval cadence: val(params, patch, batch, draws)
    -> scalar metrics plus per-example extras (`ex_*`), the gripper tokens
    against the original labels, and the patched images (`_patched_images`).
    `draws` is a StepDraws with one PatchDraws. The clean-image gripper
    filter is its own step (make_clean_filter_step)."""
    maskidx = tuple(maskidx)

    @torch.no_grad()
    def val(params: Dict, patch: torch.Tensor, batch: AttackBatch, draws: StepDraws):
        labels = prepare_labels(spec, batch.labels, target_tensor(target_tokens, batch.images.device),
                                 maskidx, draws.coin)
        patched = apply_patch_batch(batch.images, patch, draws.inner[0], geometry=spec.geometry,
                                    resize_patch=spec.resize_patch)
        pixels = dual_normalize(patched).to(torch_dtype(cfg))
        out = vla_forward(params, cfg, batch.input_ids, batch.attention_mask, pixels, labels)
        loss, metrics = _objective_loss(spec, cfg, out, labels)
        metrics = dict(metrics, loss=loss)

        base_obj = "upa" if spec.objective.startswith("upa") else spec.objective
        per_ex = per_example_metrics(out.logits, labels, cfg, base_obj, spec.mse_weight)
        metrics.update({f"ex_{k}": v for k, v in per_ex.items()})

        # gripper flips are counted against the ORIGINAL labels
        o_preds, o_gt, o_mask = action_preds_and_mask(out.logits, batch.labels, cfg)
        grip_slot = torch.argsort((~o_mask).to(torch.uint8), dim=-1, stable=True)[:, 6:7]
        metrics["gripper_pred_token"] = torch.gather(o_preds, 1, grip_slot)[:, 0]
        metrics["gripper_gt_token"] = torch.gather(o_gt, 1, grip_slot)[:, 0]
        metrics["clean_gripper_correct"] = torch.ones(batch.images.shape[0], dtype=torch.bool,
                                                      device=batch.images.device)
        if spec.objective == "uada" and len(maskidx) > 0:
            preds, gt, mask = action_preds_and_mask(out.logits, labels, cfg)
            gt_act = decode_tokens(torch.where(mask, gt, torch.full_like(gt, ACTION_TOKEN_ZERO)))
            rd = per_dim_relative_distance(decode_tokens(preds), gt_act, mask, maskidx)
            metrics.update({f"rd_{k}": v for k, v in rd.items()})
        metrics["_patched_images"] = patched
        return metrics

    return val


def make_clean_filter_step(cfg: VLAConfig):
    """No-grad clean-image gripper pre-filter: per example, whether the
    gripper token predicted on the UNPATCHED image is correct."""

    @torch.no_grad()
    def clean(params: Dict, batch: AttackBatch) -> torch.Tensor:
        pixels = dual_normalize(batch.images).to(torch_dtype(cfg))
        out = vla_forward(params, cfg, batch.input_ids, batch.attention_mask, pixels, None)
        c_preds, c_gt, c_mask = action_preds_and_mask(out.logits, batch.labels, cfg)
        last = torch.argsort((~c_mask).to(torch.uint8), dim=-1, stable=True)[:, 6:7]
        return torch.gather(c_preds, 1, last)[:, 0] == torch.gather(c_gt, 1, last)[:, 0]

    return clean
