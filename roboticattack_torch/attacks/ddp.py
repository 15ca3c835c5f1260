"""The data-parallel attack step with the reference DDP's gradient semantics
(the JAX package's `attacks/ddp.py`, `--ddp_semantics exact`).

The default data-parallel step (attacks/engine.py with a mesh) computes the
GLOBAL-batch loss. torch DDP (UADA_ddp.py:144-221) instead averages the
PER-RANK gradients of PER-RANK mean losses; when ranks hold different
numbers of valid action tokens the two differ by the token-count weighting.
This step is DDP's:
  - each rank takes the gradient of its local mean loss on its rows;
  - the gradient all-reduce divided by the world size (DDP's bucket
    all-reduce, JAX's `pmean`);
  - the L1 clip after the reduce, `grad_mean` after the clip;
  - the metrics averaged over the ranks (`dist.all_reduce(AVG)`), in one
    all-reduce of the packed scalars;
  - the (replicated) patch update runs identically on every rank.
Each rank draws its own placements and `upa_guide` coin (the reference's
per-rank torch RNG; JAX folds the device index into the step's keys).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.config import VLAConfig
from ..parallel.mesh import DataMesh, all_reduce_sum
from .engine import (
    AttackBatch,
    AttackSpec,
    AttackState,
    StepDraws,
    patch_loss_and_grad,
    prepare_labels,
    target_tensor,
    update_patch,
)

# the metrics of each objective's local loss (JAX ddp.py `_local_loss`)
LOCAL_METRICS = {
    "tma": ("ce", "l1"),
    "uada": ("ce", "mse_distance", "uad"),
    "upa": ("ce", "angle", "distance"),
    "upa_guide": ("ce",),
    "upa_negce": ("ce",),
}


def make_ddp_attack_step(spec: AttackSpec, cfg: VLAConfig, target_tokens: Optional[np.ndarray],
                         maskidx: Sequence[int], mesh: DataMesh):
    """step(params, state, batch, lr, draws) -> (state, metrics): `batch`
    and `draws` are this rank's own rows and draws; each metric is stacked
    over the inner steps and equal on every rank."""
    maskidx = tuple(maskidx)
    if spec.accumulate_steps != 1:
        raise NotImplementedError(
            "make_ddp_attack_step supports accumulate_steps=1 only (the reference DDP "
            "variant, UADA_ddp.py, has no accumulation either); use the default step "
            "for accumulation")
    keys = LOCAL_METRICS[spec.objective]

    def step(params: Dict, state: AttackState, batch: AttackBatch, lr: float, draws: StepDraws):
        if len(draws.inner) != spec.inner_loop:
            raise ValueError(f"{len(draws.inner)} inner draws for inner_loop={spec.inner_loop}")
        dev = batch.images.device
        labels = prepare_labels(spec, batch.labels, target_tensor(target_tokens, dev), maskidx, draws.coin)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        history = []
        for d in draws.inner:
            loss, aux, grad = patch_loss_and_grad(spec, cfg, params, state.patch, batch, labels, d)
            # THE DDP all-reduce: the mean of the ranks' gradients
            state, grad = update_patch(spec, state, all_reduce_sum(grad, mesh) / mesh.size, lr_t)
            names = [*keys, "loss"]
            local = torch.stack([aux[k].float() for k in keys] + [loss.float()])
            mean = all_reduce_sum(local, mesh) / mesh.size
            metrics = {k: mean[i] for i, k in enumerate(names)}
            metrics["grad_mean"] = grad.mean()
            history.append(metrics)
        return state, {k: torch.stack([h[k] for h in history]) for k in history[0]}

    return step
