"""Host-side attack runner around the step (the JAX package's
`attacks/attacker.py`): feeds batches, advances the LR schedule, gates the
accumulation boundaries, draws each step's randomness, validates on the
eval cadence and writes the artifacts.

The device is the one the params live on. With a mesh (parallel/mesh.py)
every rank runs this runner on the same global batch stream: it keeps its
rows of each batch, draws the global batch's randomness (`gspmd`) or its
own (`exact`, attacks/ddp.py), and every file is written by rank 0 alone;
the metrics, `best` and the histories are equal on every rank.

Aggregation: per-example val metrics are averaged over the selected
examples; checkpoint selection (TMA: val L1, UADA: val MSE distance, UPA:
val reverse loss) is the reference's.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.prefetch import host_prefetch
from ..models.config import VLAConfig
from ..parallel.mesh import all_gather_rows, broadcast_object, process_zero, replicate, shard_batch
from ..utils.constants import ACTION_DIM, ACTION_TOKEN_MIN, ACTION_TOKEN_ZERO
from ..utils.labels import build_tma_target_tokens, gripper_open_rows
from ..utils.profiling import StepTimer, maybe_trace
from ..training import checkpointing
from ..utils.tracking import Tracker
from .artifacts import plot_loss_curve, save_checkpoint, save_history_pickles
from .ddp import make_ddp_attack_step
from .engine import (
    AttackBatch,
    AttackSpec,
    AttackState,
    batch_to_device,
    draw_step,
    init_attack_state,
    make_attack_step,
    make_clean_filter_step,
    make_val_step,
)
from .optimizer import AdamState, cosine_schedule_with_warmup


def filter_gripper_open(batch: AttackBatch, rng: np.random.Generator) -> AttackBatch:
    """--filterGripTrainTo1: train only on gripper-open examples, resampled
    with replacement up to the full batch (one shape for every step); a
    batch with at most one open row passes unchanged."""
    open_rows = gripper_open_rows(torch.as_tensor(np.asarray(batch.labels))).numpy()
    idx = np.nonzero(open_rows)[0]
    if idx.size <= 1:
        return batch
    chosen = rng.choice(idx, size=np.asarray(batch.labels).shape[0], replace=True)
    return AttackBatch(*(np.asarray(a)[chosen] for a in batch))


@dataclass
class AttackConfig:
    """The reference CLI flag surface."""

    objective: str = "tma"                 # tma | uada | upa | upa_guide | upa_negce
    maskidx: Sequence[int] = (0,)
    lr: float = 2e-3
    num_iter: int = 2000
    accumulate_steps: int = 1
    batch_size: int = 8
    warmup: int = 20
    filter_grip_train_to_1: bool = False
    geometry: bool = True
    patch_size: Sequence[int] = (3, 50, 50)   # reference CHW order
    inner_loop: int = 50
    resize_patch: bool = False
    target_action: float = 0.0                # TMA: target = targetAction * ones(7)
    optimizer: str = "adamW"
    mse_weight: float = 5.0
    add_inverse_ce: bool = True
    upa_alpha: float = 0.8
    upa_beta: float = 0.2
    eval_every: int = 100
    eval_batches: int = 100
    seed: int = 42
    ddp_semantics: str = "gspmd"

    @property
    def patch_hw(self):
        c, h, w = self.patch_size
        if c != 3:
            raise ValueError(f"patch_size is CHW like the reference; got {self.patch_size}")
        return (h, w)

    def spec(self) -> AttackSpec:
        return AttackSpec(
            objective=self.objective,
            geometry=self.geometry,
            resize_patch=self.resize_patch,
            inner_loop=self.inner_loop,
            accumulate_steps=self.accumulate_steps,
            optimizer=self.optimizer,
            pgd_alpha=self.lr,
            mse_weight=self.mse_weight,
            add_inverse_ce=self.add_inverse_ce,
            upa_alpha=self.upa_alpha,
            upa_beta=self.upa_beta,
            # the L1 clip sits in the shared adamW branch of every UPA variant
            grad_clip_l1=(1e-3 if self.objective.startswith("upa") and self.optimizer == "adamW" else None),
        )


@dataclass
class AttackResult:
    patch: np.ndarray                      # [H, W, 3] float32
    best_metric: float
    histories: Dict[str, List[float]] = field(default_factory=dict)
    timing: Dict[str, float] = field(default_factory=dict)  # StepTimer summary


# objective -> (val metric key, sign): +1 minimizes, -1 maximizes
_BEST_KEY = {
    "tma": ("val_l1", 1.0),
    "uada": ("val_mse_distance", 1.0),
    "upa": ("val_loss", 1.0),
    "upa_guide": ("val_ce", 1.0),
    "upa_negce": ("val_ce", -1.0),
}


def _first_tensor(tree) -> torch.Tensor:
    for v in tree.values():
        return _first_tensor(v) if isinstance(v, dict) else v
    raise ValueError("empty parameter tree")


class OpenVLAAttacker:
    def __init__(
        self,
        params,
        cfg: VLAConfig,
        save_dir: str,
        attack: AttackConfig,
        mesh=None,
        tracker: Optional[Tracker] = None,
        data_counters: Optional[Dict] = None,
    ) -> None:
        self.exact = attack.ddp_semantics == "exact"
        if self.exact and mesh is None:
            raise ValueError("ddp_semantics='exact' needs a data mesh (--data_parallel true)")
        if mesh is not None and mesh.tp > 1:
            # the JAX runner replicates the weights on a (data, model) mesh
            # (its attacker.py `replicate(params, mesh)`): each rank of a
            # model group runs its replica's step on the whole weights
            mesh = mesh._replace(model_group=None, m=0, tp=1)
        self.cfg = cfg
        self.attack = attack
        self.save_dir = save_dir
        self.mesh = mesh
        self.tracker = tracker or Tracker(save_dir, quiet=False)
        # the data plane's frames_seen / frames_skipped_pad_to, updated in place
        self.data_counters = data_counters
        self.writes = 0
        self._write(os.makedirs, save_dir, exist_ok=True)
        # every rank builds the same weights: they stay where they are
        self.params = params.tree() if isinstance(params, nn.Module) else params
        self.device = _first_tensor(self.params).device

        target = None
        if attack.objective == "tma":
            target = build_tma_target_tokens(attack.target_action * np.ones(ACTION_DIM), attack.maskidx)
        self._target = target
        self.spec = attack.spec()
        if self.exact:
            exact = make_ddp_attack_step(self.spec, cfg, target, attack.maskidx, mesh)

            # no accumulation under exact (refused inside): apply_update is
            # always true
            def step(params, state, batch, lr, apply_update, draws):
                del apply_update
                return exact(params, state, batch, lr, draws)

            self._step = step
        else:
            self._step = make_attack_step(self.spec, cfg, target, attack.maskidx, mesh)
        self._val = make_val_step(self.spec, cfg, target, attack.maskidx, mesh)
        self._clean_val = make_clean_filter_step(cfg, mesh) if list(attack.maskidx) == [6] else None
        self.histories: Dict[str, List[float]] = {}
        self.best = float("inf")

    def _write(self, fn, *args, **kw) -> None:
        """fn(*args, **kw), a write under the run dir, on rank 0 alone;
        `writes` counts this process's."""
        if process_zero():
            fn(*args, **kw)
            self.writes += 1

    def _record(self, name: str, value: float) -> None:
        self.histories.setdefault(name, []).append(float(value))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_state(self, state: AttackState, iteration: int) -> str:
        """The resumable state (patch, AdamW moments, grad buffer, best
        metric, histories) as a checkpoint under attack_state/ (the JAX
        package's layout: step-<N>-epoch-00/ and latest-checkpoint)."""
        payload = {
            "patch": state.patch, "grad_acc": state.grad_acc,
            "opt": {"m": state.opt.m, "v": state.opt.v, "count": state.opt.count},
            "_best": float(self.best),
            "_histories": {k: list(v) for k, v in self.histories.items()},
        }
        return checkpointing.save_checkpoint(os.path.join(self.save_dir, "attack_state"), step=iteration,
                                             params=payload)

    def load_state(self, resume_dir: str) -> tuple:
        """The latest attack state under resume_dir/attack_state: a
        checkpoint, or the newest step-<N>.pt of a run written before the
        checkpoint layout."""
        d = os.path.join(resume_dir, "attack_state")
        path = checkpointing.latest_checkpoint(d)
        if path is not None:
            payload = checkpointing.restore_checkpoint(path)["params"]
            step = int(re.match(r"step-(\d+)", os.path.basename(path)).group(1))
            opt = payload["opt"]
        else:
            steps = sorted(int(m.group(1)) for f in (os.listdir(d) if os.path.isdir(d) else [])
                           if (m := re.fullmatch(r"step-(\d+)\.pt", f)))
            if not steps:
                raise FileNotFoundError(f"no attack_state checkpoints under {resume_dir}")
            step = steps[-1]
            payload = torch.load(os.path.join(d, f"step-{step:06d}.pt"), map_location="cpu",
                                 weights_only=True)
            opt = payload
        dev = self.device
        state = AttackState(
            patch=payload["patch"].to(dev),
            opt=AdamState(*(opt[k].to(dev) for k in ("m", "v", "count"))),
            grad_acc=payload["grad_acc"].to(dev),
        )
        self.best = float(payload["_best"])
        self.histories = {k: list(v) for k, v in payload["_histories"].items()}
        # saved after completing the step; resume at the next one
        return state, step + 1

    def _resume(self, resume_from: str) -> tuple:
        """load_state, or under a mesh rank 0's state, best and histories
        broadcast to every rank."""
        if self.mesh is None or self.mesh.rank == 0:
            state, start = self.load_state(resume_from)
        else:  # a state of the same shapes, overwritten by rank 0's
            state, start = init_attack_state(None, self.attack.patch_hw, self.device), None
        if self.mesh is not None:
            state = replicate(state, self.mesh)
            start, self.best, self.histories = broadcast_object((start, self.best, self.histories), self.mesh)
        if process_zero():
            print(f"resumed attack state from {resume_from} at iter {start}")
        return state, start

    def _place(self, nb) -> tuple:
        """A global numpy batch -> (this rank's rows on the device, the
        global images and labels shapes that the draws take)."""
        shapes = (np.shape(nb.images), np.shape(nb.labels))
        if self.mesh is not None:
            nb = shard_batch(nb, self.mesh)
        return batch_to_device(nb, self.device, non_blocking=True), shapes

    def _draws(self, seed: int, shapes: tuple):
        """The step's draws from `seed`: the global batch's, the same on
        every rank (one process, `gspmd`), or under `exact` each rank's own
        stream over its rows (seed * W + rank)."""
        images_shape, labels_shape = shapes
        if self.exact:
            w = self.mesh.size
            seed = seed * w + self.mesh.rank
            images_shape = (images_shape[0] // w, *images_shape[1:])
            labels_shape = (labels_shape[0] // w, *labels_shape[1:])
        return draw_step(torch.Generator().manual_seed(seed), self.spec, images_shape,
                         self.attack.patch_hw, labels_shape)

    def run(
        self,
        train_batches: Iterator[AttackBatch],
        val_batches: Iterator[AttackBatch],
        profile_dir: Optional[str] = None,
        resume_from: Optional[str] = None,
    ) -> AttackResult:
        a = self.attack
        timer = StepTimer()
        rng_np = np.random.default_rng(a.seed)
        start_iter = 0
        if resume_from is not None:
            state, start_iter = self._resume(resume_from)
        else:
            state = init_attack_state(torch.Generator().manual_seed(a.seed), a.patch_hw, self.device)
            if self.mesh is not None:
                state = replicate(state, self.mesh)
        sched_total = int(a.num_iter / a.accumulate_steps)
        grip_filter = a.filter_grip_train_to_1 and list(a.maskidx) == [6]
        # the host side of the next batches (reading, decoding, tokenizing,
        # collating) runs on a daemon thread while the device computes
        train_batches = host_prefetch(train_batches, depth=2)

        def next_placed():
            nb = next(train_batches)
            if grip_filter:  # on the global batch, in lockstep on every rank
                nb = filter_gripper_open(nb, rng_np)
            return self._place(nb)

        # a resume that is already complete takes no batch
        if start_iter < a.num_iter:
            staged = next_placed()
        for i in range(start_iter, a.num_iter):
            batch, shapes = staged
            lr = cosine_schedule_with_warmup(i // a.accumulate_steps, a.lr, a.warmup, sched_total)
            apply_update = (i + 1) % a.accumulate_steps == 0
            draws = self._draws(a.seed * 1000003 + i, shapes)
            # step 1, not the first: the first carries one-time setup
            with maybe_trace(profile_dir if i == 1 else None), timer:
                state, metrics = self._step(self.params, state, batch, lr, apply_update, draws)
                # stage the next batch's copy to the card while the step runs
                # (the step is queued, not finished), as the JAX runner does
                if i + 1 < a.num_iter:
                    staged = next_placed()
                self._sync()

            host = {k: v.float().cpu().numpy() for k, v in metrics.items()}
            last = {k: float(v[-1]) for k, v in host.items()}
            mean_loss = float(host["loss"].mean())
            self._record("train_CE_loss", last.get("ce", last["loss"]))
            self._record("train_inner_avg_loss", mean_loss)
            log = {f"TRAIN_{k}": v for k, v in last.items()}
            log["TRAIN_LR"] = lr
            log["TRAIN_inner_avg_loss"] = mean_loss
            self.tracker.log(log, step=i)

            if i % a.eval_every == 0:
                if self.data_counters and self.data_counters.get("frames_seen"):
                    seen = self.data_counters["frames_seen"]
                    skipped = self.data_counters.get("frames_skipped_pad_to", 0)
                    self.tracker.log({"DATA_frames_seen": seen,
                                      "DATA_frames_skipped_pad_to": skipped,
                                      "DATA_pad_to_skip_rate": skipped / seen}, step=i)
                self._validate(state, val_batches, i)
                self._write(self.save_state, state, i)

        patch = state.patch.cpu().numpy()
        self._write(save_checkpoint, self.save_dir, "final", patch)
        self._write(save_history_pickles, self.save_dir, self.histories)
        summary = timer.summary()
        if summary:
            self.tracker.log({f"TIMING_{k}": v for k, v in summary.items()}, step=a.num_iter)
        return AttackResult(patch=patch, best_metric=self.best, histories=self.histories, timing=summary)

    def _validate(self, state: AttackState, val_batches: Iterator[AttackBatch], step: int) -> None:
        a = self.attack
        is_grip_target = list(a.maskidx) == [6]
        sums: Dict[str, float] = {}
        count = 0.0
        batch_loss_sum, batch_count = 0.0, 0
        grip = {k: 0.0 for k in ("zero_flipped", "zero_total", "one_flipped", "one_total",
                                 "other_to_zero", "other_total")}
        adv_images = None
        for j in range(a.eval_batches):
            batch, shapes = self._place(next(val_batches))
            # the val step's draws are the global batch's under either
            # semantics (the JAX runner scores DP with the sharded val step)
            draws = draw_step(torch.Generator().manual_seed(a.seed * 7 + step * 131 + j), self.spec,
                              shapes[0], a.patch_hw, shapes[1], inner=1)
            m = self._val(self.params, state.patch, batch, draws)
            if self._clean_val is not None:
                m["clean_gripper_correct"] = self._clean_val(self.params, batch)
            patched = m.pop("_patched_images")
            m = {k: v.cpu().numpy() for k, v in m.items()}
            # the clean-gripper-correct filter for TMA on the gripper dim, else
            # every example
            sel = (m["clean_gripper_correct"].astype(bool) if (a.objective == "tma" and is_grip_target)
                   else np.ones(shapes[0][0], bool))
            n = float(sel.sum())
            if n == 0:
                continue
            count += n
            for k, v in m.items():
                if k.startswith("ex_"):
                    sums[k[3:]] = sums.get(k[3:], 0.0) + float(np.asarray(v)[sel].sum())
            batch_loss_sum += float(m["loss"])
            batch_count += 1
            gp, gg = m["gripper_pred_token"][sel], m["gripper_gt_token"][sel]
            is_zero, is_one = gg == ACTION_TOKEN_ZERO, gg == ACTION_TOKEN_MIN
            is_other = ~is_zero & ~is_one
            grip["zero_total"] += float(is_zero.sum())
            grip["zero_flipped"] += float((is_zero & (gp != ACTION_TOKEN_ZERO)).sum())
            grip["one_total"] += float(is_one.sum())
            grip["one_flipped"] += float((is_one & (gp != ACTION_TOKEN_MIN)).sum())
            grip["other_total"] += float(is_other.sum())
            grip["other_to_zero"] += float((is_other & (gp == ACTION_TOKEN_ZERO)).sum())
            if j == a.eval_batches - 1:
                if self.mesh is not None:  # every rank's rows, for rank 0's dump
                    patched = all_gather_rows(patched, self.mesh)
                adv_images = patched.cpu().numpy()
        if count == 0:
            return
        avg = {f"val_{k}": v / count for k, v in sums.items()}
        # UPA's reverse loss is batch-level (1 / mean dist per batch), so it is
        # averaged over batches, not recomposed from examples
        if a.objective == "upa" and batch_count:
            avg["val_loss"] = batch_loss_sum / batch_count
        if is_grip_target:
            for num, den, name in (("zero_flipped", "zero_total", "ASR_02other"),
                                   ("one_flipped", "one_total", "ASR_12other"),
                                   ("other_to_zero", "other_total", "ASR_other20")):
                avg[name] = grip[num] / grip[den] if grip[den] else 0.0
            tot = grip["zero_total"] + grip["one_total"]
            avg["ALL_ASR_6"] = (grip["zero_flipped"] + grip["one_flipped"]) / tot if tot else 0.0

        self.tracker.log({f"VAL_{k}": v for k, v in avg.items()}, step=step)
        for k, v in avg.items():
            self._record(k, v)

        best_key, best_sign = _BEST_KEY[a.objective]
        patch = state.patch.cpu().numpy()
        if best_key in avg and best_sign * avg[best_key] < self.best:
            self.best = best_sign * avg[best_key]
            self._write(save_checkpoint, self.save_dir, str(step), patch, adv_images=adv_images)
        self._write(save_checkpoint, self.save_dir, "last", patch, adv_images=adv_images)
        self._write(plot_loss_curve, self.histories.get("train_CE_loss", []), self.save_dir)
        self._write(save_history_pickles, self.save_dir, self.histories)
