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

Data parallelism (`mesh`, parallel/mesh.py): each rank holds its rows of
the batch and is given the GLOBAL batch's draws, of which it takes its
rows. The objective becomes the global-batch objective through one
all-reduce of its packed sums (losses.py `global_sums`), and one all-reduce
of the patch gradient sums the ranks' contributions: the step at any world
size is the single-process step on the whole batch (the JAX package's step
on a sharded batch).

A model axis (`make_mesh(model > 1)`) adds the Megatron split: `params` is
this rank's shard (parallel.shard_params), the forward and backward call
the model group's collectives (parallel/tensor_parallel.py) and the
objectives reduce over the vocab slices (losses.py). The patch gradient
then comes out equal on the ranks of a model group, so the data-axis
all-reduces above stay one each per inner step, over the data group; the
rows and draws are cut by the replica index d.

On a CUDA device without a mesh, the work from the patched pixels on (the
forward, the objective and the pixels' gradient) is one CUDA graph,
captured at a step function's second call of a batch shape and replayed at
every inner step after it (attacks/graphed.py); the paste chain, its
backward and the update stay eager around it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.config import VLAConfig, torch_dtype
from ..models.vlm import vla_forward
from ..ops.patch_ops import PatchDraws, apply_patch_batch, draw_patch_params
from ..parallel.mesh import all_gather_rows, all_reduce_sum, shard_batch
from ..utils.action_tokenizer import decode_tokens
from ..utils.constants import ACTION_TOKEN_ZERO
from ..utils.labels import change_target, draw_coin, mask_labels, overwrite_with_target
from ..utils.normalization import dual_normalize
from ..utils.profiling import count, outer_step, span
from . import graphed
from .losses import (
    action_preds_and_mask,
    clip_grad_l1,
    global_sums,
    local_sums,
    loss_from_sums,
    per_dim_relative_distance,
    per_example_metrics,
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


def batch_to_device(batch, device, non_blocking: bool = False) -> AttackBatch:
    """A numpy batch (data/collator.py) -> tensors on `device`: f32 images,
    int64 ids, mask and labels. With `non_blocking` and a CUDA device, each
    array is converted on the host, pinned and copied without waiting: the
    copy is queued on the current stream behind the work already there."""
    images, ids, mask, labels = (torch.as_tensor(np.asarray(a)) for a in batch)
    host = (images.float(), ids.long(), mask.long(), labels.long())
    if non_blocking and torch.device(device).type == "cuda":
        host = tuple(t.pin_memory() for t in host)
    return AttackBatch(*(t.to(device, non_blocking=non_blocking) for t in host))


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


def _objective_loss(spec: AttackSpec, cfg: VLAConfig, logits, labels, reduce=None,
                    extra: Optional[Dict[str, torch.Tensor]] = None, mesh=None):
    """(loss, metrics, sums) of the objective over this batch, or, with
    `reduce` (the all-reduce of a packed vector of sums), over the global
    batch. `extra` sums ride in the same reduce."""
    local = local_sums(spec.objective, logits, labels, cfg, spec.mse_weight, mesh)
    local.update(extra or {})
    sums = global_sums(local, reduce)
    loss, metrics = loss_from_sums(spec.objective, sums, spec.add_inverse_ce, spec.upa_alpha, spec.upa_beta)
    return loss, metrics, sums


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


def mesh_reducer(mesh):
    """The packed-sums reduce of `mesh` (None without one)."""
    return None if mesh is None else (lambda v: all_reduce_sum(v, mesh))


def patch_pixels(spec: AttackSpec, cfg: VLAConfig, images: torch.Tensor, patch: torch.Tensor,
                 draws: PatchDraws) -> torch.Tensor:
    """The model's pixels of the patched batch: the paste, the warp and the
    composite, both towers' normalizations, the cast to the model dtype."""
    with span("attack.patch"):
        patched = apply_patch_batch(images, patch, draws, geometry=spec.geometry, resize_patch=spec.resize_patch)
        return dual_normalize(patched).to(torch_dtype(cfg))


def _objective(spec: AttackSpec, cfg: VLAConfig, params: Dict, input_ids, attention_mask, labels, pixels,
               mesh=None):
    """(loss, metrics) of the VLA on `pixels`: TMA's loss over
    accumulate_steps."""
    with span("attack.forward"):
        # the CE comes from the objective's sums, not out.loss
        out = vla_forward(params, cfg, input_ids, attention_mask, pixels, None, mesh=mesh)
    with span("attack.objective"):
        loss, metrics, _ = _objective_loss(spec, cfg, out.logits, labels, mesh_reducer(mesh), mesh=mesh)
        if spec.objective == "tma":
            loss = loss / spec.accumulate_steps
    return loss, metrics


def pixel_loss_and_grad(spec: AttackSpec, cfg: VLAConfig, params: Dict, input_ids, attention_mask, labels,
                        pixels: torch.Tensor, mesh=None):
    """(loss, metrics, grad) of one batch, the gradient with respect to
    `pixels`, a leaf: the work from the pixels on, run eager or captured
    into the attack step's CUDA graph (attacks/graphed.py)."""
    with torch.enable_grad():
        loss, metrics = _objective(spec, cfg, params, input_ids, attention_mask, labels, pixels, mesh)
        # the checkpointed blocks recompute in here, on the autograd engine's thread on CUDA
        with span("attack.backward", backward=True):
            (grad,) = torch.autograd.grad(loss, pixels)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grad


def patch_loss_and_grad(spec: AttackSpec, cfg: VLAConfig, params: Dict, patch: torch.Tensor,
                        batch: AttackBatch, labels, draws: PatchDraws, mesh=None, region=None):
    """The objective of one inner step and its gradient with respect to the
    patch pixels alone: (loss, metrics, grad). The chain rule is split at
    the model's pixels: `region(pixels) -> (loss, metrics, pixel_grad)`, a
    prepared graph's `run`, or by default pixel_loss_and_grad on this batch,
    then the paste chain's backward to the patch. With a mesh, `batch`,
    `labels` and `draws` are this rank's rows, and the loss, metrics and
    gradient are the global batch's (one all-reduce of the packed sums, one
    of the gradient)."""
    patch = patch.detach().requires_grad_(True)
    with torch.enable_grad():
        pixels = patch_pixels(spec, cfg, batch.images, patch, draws)
        if region is None:
            loss, metrics, pixel_grad = pixel_loss_and_grad(spec, cfg, params, batch.input_ids, batch.attention_mask,
                                                            labels, pixels.detach().requires_grad_(True), mesh)
        else:
            loss, metrics, pixel_grad = region(pixels)
        (grad,) = torch.autograd.grad(pixels, patch, pixel_grad)
    if mesh is not None:
        grad = all_reduce_sum(grad, mesh)
    return loss, metrics, grad


def update_patch(spec: AttackSpec, state: AttackState, grad: torch.Tensor, lr) -> Tuple[AttackState, torch.Tensor]:
    """The patch update of a (summed or reduced) gradient: the L1 clip,
    AdamW or PGD, the clamp to [0, 1] and an emptied accumulation buffer.
    Returns the new state and the gradient the optimizer took."""
    with span("attack.update"):
        if spec.grad_clip_l1 is not None:
            grad = clip_grad_l1(grad, spec.grad_clip_l1)
        if spec.optimizer == "adamW":
            new_patch, opt = adamw_update(grad, state.opt, state.patch, lr)
        elif spec.optimizer == "pgd":
            new_patch, opt = pgd_update(grad, state.patch, spec.pgd_alpha), state.opt
        else:
            raise ValueError(f"unknown optimizer {spec.optimizer}")
        return AttackState(patch=new_patch.clamp(0.0, 1.0), opt=opt, grad_acc=torch.zeros_like(grad)), grad


def _inner_step(spec: AttackSpec, cfg: VLAConfig, params: Dict, state: AttackState,
                batch: AttackBatch, labels, lr, apply_update: bool,
                draws: PatchDraws, mesh=None, replay=None) -> Tuple[AttackState, Dict[str, torch.Tensor]]:
    if replay is None:
        loss, metrics, grad = patch_loss_and_grad(spec, cfg, params, state.patch, batch, labels, draws, mesh)
    else:
        loss, metrics, grad = patch_loss_and_grad(spec, cfg, params, state.patch, batch, labels, draws,
                                                  region=replay)
    metrics.update(loss=loss, grad_mean=grad.mean())

    grad_total = state.grad_acc + grad
    if not apply_update:
        # accumulation: the patch and optimizer wait, the buffer keeps the
        # raw gradients
        return AttackState(patch=state.patch, opt=state.opt, grad_acc=grad_total), metrics
    # clip only at update time; clipping the running buffer each inner step
    # would rescale earlier contributions again and again
    return update_patch(spec, state, grad_total, lr)[0], metrics


def target_tensor(target_tokens, device):
    return None if target_tokens is None else torch.as_tensor(np.asarray(target_tokens), device=device)


def make_attack_step(spec: AttackSpec, cfg: VLAConfig, target_tokens: Optional[np.ndarray],
                     maskidx: Sequence[int], mesh=None):
    """step(params, state, batch, lr, apply_update, draws) -> (state,
    metrics), each metric stacked over the inner steps ([inner_loop]).
    With a mesh, `batch` is this rank's rows and `draws` the global
    batch's. On a CUDA device without a mesh the step replays a CUDA graph
    of the forward and the pixels' gradient from its second call of a
    batch shape on (attacks/graphed.py)."""
    maskidx = tuple(maskidx)
    graph = graphed.GraphedObjective(
        lambda params, ids, mask, labels, pixels: pixel_loss_and_grad(spec, cfg, params, ids, mask, labels, pixels))

    def step(params: Dict, state: AttackState, batch: AttackBatch, lr: float,
             apply_update: bool, draws: StepDraws):
        if len(draws.inner) != spec.inner_loop:
            raise ValueError(f"{len(draws.inner)} inner draws for inner_loop={spec.inner_loop}")
        if mesh is not None:
            draws = shard_batch(draws, mesh)
        dev = batch.images.device
        with outer_step("attack.step", dev):
            labels = prepare_labels(spec, batch.labels, target_tensor(target_tokens, dev), maskidx, draws.coin)
            lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
            replay = (graph.prepare(params, batch.images, batch.input_ids, batch.attention_mask, labels)
                      if graphed.applies(dev, mesh) else None)
            count("attack.graph_replays", 0)  # each replay adds 1: an eager step reads 0
            history: List[Dict[str, torch.Tensor]] = []
            for d in draws.inner:
                with span("attack.inner"):
                    state, metrics = _inner_step(spec, cfg, params, state, batch, labels, lr_t,
                                                 bool(apply_update), d, mesh, replay)
                history.append(metrics)
            return state, {k: torch.stack([h[k] for h in history]) for k in history[0]}

    return step


def _gather_per_example(metrics: Dict[str, torch.Tensor], keys, mesh) -> None:
    """Replace each per-example [B_local] entry of `metrics` by the global
    batch's [B], through ONE all-gather of the packed f32 rows (token ids
    and flags are exact in f32)."""
    packed = torch.stack([metrics[k].float() for k in keys], dim=1)
    rows = all_gather_rows(packed, mesh)
    for i, k in enumerate(keys):
        metrics[k] = rows[:, i].to(metrics[k].dtype)


def make_val_step(spec: AttackSpec, cfg: VLAConfig, target_tokens: Optional[np.ndarray],
                  maskidx: Sequence[int], mesh=None):
    """No-grad scorer of the eval cadence: val(params, patch, batch, draws)
    -> scalar metrics plus per-example extras (`ex_*`), the gripper tokens
    against the original labels, and the patched images (`_patched_images`).
    `draws` is a StepDraws with one PatchDraws. The clean-image gripper
    filter is its own step (make_clean_filter_step). With a mesh, `batch`
    is this rank's rows and `draws` the global batch's: the scalars come
    from the global sums (one all-reduce) and the per-example entries are
    gathered (one all-gather), so every rank holds what one process
    computes on the whole batch; `_patched_images` stays this rank's rows."""
    maskidx = tuple(maskidx)
    reduce = mesh_reducer(mesh)

    @torch.no_grad()
    def val(params: Dict, patch: torch.Tensor, batch: AttackBatch, draws: StepDraws):
        if mesh is not None:
            draws = shard_batch(draws, mesh)
        labels = prepare_labels(spec, batch.labels, target_tensor(target_tokens, batch.images.device),
                                 maskidx, draws.coin)
        patched = apply_patch_batch(batch.images, patch, draws.inner[0], geometry=spec.geometry,
                                    resize_patch=spec.resize_patch)
        pixels = dual_normalize(patched).to(torch_dtype(cfg))
        out = vla_forward(params, cfg, batch.input_ids, batch.attention_mask, pixels, None, mesh=mesh)
        rd = {}
        if spec.objective == "uada" and len(maskidx) > 0:
            preds, gt, mask = action_preds_and_mask(out.logits, labels, cfg, mesh)
            gt_act = decode_tokens(torch.where(mask, gt, torch.full_like(gt, ACTION_TOKEN_ZERO)))
            rd = per_dim_relative_distance(decode_tokens(preds), gt_act, mask, maskidx)
        # the per-dim means ride in the objective's reduce as row sums
        rows = float(batch.images.shape[0])
        extra = {f"rd_{k}": v * rows for k, v in rd.items()}
        extra["rd_rows"] = torch.tensor(rows, device=batch.images.device)
        loss, metrics, sums = _objective_loss(spec, cfg, out.logits, labels, reduce, extra, mesh)
        rd = {k: sums[f"rd_{k}"] / sums["rd_rows"] for k in rd}
        metrics = dict(metrics, loss=loss)

        base_obj = "upa" if spec.objective.startswith("upa") else spec.objective
        per_ex = per_example_metrics(out.logits, labels, cfg, base_obj, spec.mse_weight, mesh)
        metrics.update({f"ex_{k}": v for k, v in per_ex.items()})

        # gripper flips are counted against the ORIGINAL labels
        o_preds, o_gt, o_mask = action_preds_and_mask(out.logits, batch.labels, cfg, mesh)
        grip_slot = torch.argsort((~o_mask).to(torch.uint8), dim=-1, stable=True)[:, 6:7]
        metrics["gripper_pred_token"] = torch.gather(o_preds, 1, grip_slot)[:, 0]
        metrics["gripper_gt_token"] = torch.gather(o_gt, 1, grip_slot)[:, 0]
        metrics["clean_gripper_correct"] = torch.ones(batch.images.shape[0], dtype=torch.bool,
                                                      device=batch.images.device)
        if mesh is not None:
            per_row = [k for k in metrics if k.startswith("ex_")]
            _gather_per_example(metrics, per_row + ["gripper_pred_token", "gripper_gt_token",
                                                    "clean_gripper_correct"], mesh)
        metrics.update({f"rd_{k}": v for k, v in rd.items()})
        metrics["_patched_images"] = patched
        return metrics

    return val


def make_clean_filter_step(cfg: VLAConfig, mesh=None):
    """No-grad clean-image gripper pre-filter: per example, whether the
    gripper token predicted on the UNPATCHED image is correct (with a mesh,
    gathered over the global batch)."""

    @torch.no_grad()
    def clean(params: Dict, batch: AttackBatch) -> torch.Tensor:
        pixels = dual_normalize(batch.images).to(torch_dtype(cfg))
        out = vla_forward(params, cfg, batch.input_ids, batch.attention_mask, pixels, None, mesh=mesh)
        c_preds, c_gt, c_mask = action_preds_and_mask(out.logits, batch.labels, cfg, mesh)
        last = torch.argsort((~c_mask).to(torch.uint8), dim=-1, stable=True)[:, 6:7]
        ok = torch.gather(c_preds, 1, last)[:, 0] == torch.gather(c_gt, 1, last)[:, 0]
        return ok if mesh is None else all_gather_rows(ok, mesh)

    return clean
