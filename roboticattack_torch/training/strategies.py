"""VLA fine-tuning trainer: the JAX package's `training/strategies.py` (the
reference's `TrainingStrategy` hierarchy, prismatic/training/strategies/)
as explicit PyTorch steps over a process group.

JAX jits one train step and picks a sharding; here each rank is a process
(`parallel/mesh.make_mesh`, a world of one without torchrun) and the step
calls its collectives itself:

  strategy "ddp"   -> every rank holds every leaf (broadcast from rank 0);
                      the gradients are all-reduced;
  strategy "fsdp"  -> every rank keeps its shard of each leaf and of both
                      Adam moments (`fsdp_shardings`: the largest dim the
                      world divides); the whole tree is all-gathered before
                      the forward, the gradients are all-reduced and each
                      rank keeps its shard (gloo has no reduce-scatter);
  grad checkpointing -> cfg.remat (torch.utils.checkpoint per block);
  grad accumulation  -> optax.MultiSteps' running mean, every k-th call
                        applies the update.

The loss is the global batch's CE mean over valid tokens, reduced as the
data-parallel attack reduces its sums (`attacks/losses.global_sums`): each
rank's gradient is its rows' share, and the ranks' gradients sum to the
whole batch's. In a world of one ddp and fsdp are the same step.

`AdamW` is `make_optimizer`'s optax chain on the trainable leaves, step for
step: clip_by_global_norm -> adamw(warmup-cosine schedule, eps 1e-8,
mu in f32, nu in the parameter dtype) -> p = (p + u).astype(p.dtype), each
scalar taking the dtype of the array it meets, as JAX's weak types do.
Frozen leaves (`trainable_mask`) get no gradient at all (optax's
set_to_zero), so they stay bit-equal.

Layer stacks (`llm.layers.*`, `vision.*.blocks.*`) reach the forward as a
list of per-layer leaves: indexing a stacked leaf that requires grad would
make every layer's backward write a zero tensor of the whole stack. The
update then runs a layer slice at a time, so its f32 temporaries stay the
size of one layer.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..attacks.engine import AttackBatch, batch_to_device
from ..attacks.losses import global_sums
from ..models.config import VLAConfig, torch_dtype
from ..models.llama import ce_sums
from ..models.param_tree import tree_from_leaves, tree_leaves
from ..models.vlm import vla_forward
from ..parallel.mesh import DataMesh, all_reduce_sum, make_mesh, replicate, shard_batch
from ..parallel.sharding import PartitionSpec
from ..utils.device import resolve_device
from ..utils.normalization import dual_normalize
from .metrics import VLAMetrics

Path = Tuple[str, ...]

# the stacks the forward indexes a layer at a time
LAYER_STACKS = (("llm", "layers"), ("vision", "dino", "blocks"), ("vision", "siglip", "blocks"))
B1, B2, EPS = 0.9, 0.999, 1e-8
# elements of one slice of the AdamW update (its f32 temporaries)
UPDATE_CHUNK = 1 << 26


@dataclass
class TrainConfig:
    """The knobs the VLA trainer exposes (the reference's conf/vla.py:21-57)."""

    strategy: str = "fsdp"           # ddp | fsdp
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.0
    max_steps: int = 1000
    grad_accumulation_steps: int = 1
    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = False
    seed: int = 7


def trainable_mask(params: Dict, cfg: TrainConfig) -> Dict:
    """Tree of bools: which leaves receive updates (the freeze-stage contract)."""
    flags = {"vision": not cfg.freeze_vision_backbone, "projector": True,
             "llm": not cfg.freeze_llm_backbone}
    return tree_from_leaves((path, flags[path[0]]) for path, _ in tree_leaves(params))


def lr_schedule(cfg: TrainConfig) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps=max(1,
    int(warmup_ratio * max_steps)), decay_steps=max_steps) in its float32
    arithmetic, by the count of applied updates (the first is 0: lr 0)."""
    f32 = np.float32
    warmup = max(1, int(cfg.warmup_ratio * cfg.max_steps))
    decay = cfg.max_steps - warmup
    if decay <= 0:
        raise ValueError(f"max_steps={cfg.max_steps} leaves no decay steps after {warmup} of warmup")
    peak = f32(cfg.learning_rate)

    def at(count: int) -> np.float32:
        if count < warmup:  # linear 0 -> peak: (init - end) * frac + end
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return -peak * frac + peak
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return peak * cosine

    return at


@functools.lru_cache(maxsize=256)
def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak type meets an array: rounded to the
    array's dtype (torch then multiplies by it in its opmath type)."""
    return float(torch.tensor(float(x), dtype=dtype))


def _slices(p: torch.Tensor, g) -> Iterator[Tuple[object, torch.Tensor]]:
    """(index into p, its gradient): per layer where the gradient is a list
    of per-layer leaves, otherwise the whole leaf or, past UPDATE_CHUNK
    elements, row blocks of dim 0."""
    if isinstance(g, list):
        yield from enumerate(g)
    elif p.dim() == 0 or p.numel() <= UPDATE_CHUNK:
        yield Ellipsis, g
    else:
        rows = max(1, UPDATE_CHUNK // p[0].numel())
        for s in range(0, p.shape[0], rows):
            yield slice(s, s + rows), g[s : s + rows]


class AdamW:
    """`make_optimizer`'s optax chain on a flat {path: tensor} dict of the
    trainable leaves, updated in place: optax.MultiSteps (k > 1) over
    clip_by_global_norm(max_grad_norm) -> adamw(lr_schedule, weight_decay,
    eps=1e-8, b1=0.9, b2=0.999, mu_dtype=f32).

    `mu` is f32; `nu` is in the parameter dtype, or in f32 under
    accumulation, where Adam sees the f32 running mean (MultiSteps recasts
    its accumulator to the update's dtype after every call, and optax keeps
    the promoted moment). Divisors are 0-dim tensors on the device: a
    Python-scalar divisor would become a multiply by its reciprocal on
    CUDA."""

    def __init__(self, cfg: TrainConfig, leaves: Dict[Path, torch.Tensor]) -> None:
        self.cfg = cfg
        self.k = cfg.grad_accumulation_steps
        self.schedule = lr_schedule(cfg)
        self.count = 0      # applied updates (the schedule's and Adam's count)
        self.mini_step = 0  # calls since the last applied update
        self.grad_norm: Optional[float] = None  # the last applied update's global norm
        moment = (lambda p: p.dtype) if self.k == 1 else (lambda p: torch.promote_types(p.dtype, torch.float32))
        self.mu = {path: torch.zeros_like(p, dtype=torch.float32) for path, p in leaves.items()}
        self.nu = {path: torch.zeros_like(p, dtype=moment(p)) for path, p in leaves.items()}
        self.acc = ({path: torch.zeros_like(p, dtype=moment(p)) for path, p in leaves.items()}
                    if self.k > 1 else None)

    def update(self, params: Dict[Path, torch.Tensor], grads: Dict[Path, object],
               sharded: frozenset = frozenset(), reduce=None) -> bool:
        """One call of the chain. `grads[path]` is a tensor of
        params[path]'s shape or the list of its per-layer gradients (each
        dropped once applied). The global norm's sum of squares is taken in
        f64, so that it does not depend on how the leaves are split; the
        `sharded` leaves' part goes through `reduce` (the other ranks'
        shards). Returns whether an update was applied."""
        if not grads:
            return False
        dev = next(iter(self.mu.values())).device
        if self.acc is not None:
            n = torch.tensor(float(self.mini_step + 1), device=dev)
            for path, g in grads.items():
                acc = self.acc[path]
                for idx, gi in _slices(acc, g):
                    a = acc[idx]
                    a.add_((gi - a) / n.to(a.dtype))
            self.mini_step = (self.mini_step + 1) % self.k
            if self.mini_step:
                return False
            grads = dict(self.acc)

        sq = [torch.zeros((), dtype=torch.float64, device=dev) for _ in range(2)]
        for path, g in grads.items():
            for _, gi in _slices(params[path], g):
                sq[path in sharded] += torch.linalg.vector_norm(gi, dtype=torch.float64) ** 2
        if reduce is not None:
            sq[1] = reduce(sq[1])
        g_norm = np.sqrt(np.float32(float(sq[0] + sq[1])))
        self.grad_norm = float(g_norm)
        clip = not g_norm < np.float32(self.cfg.max_grad_norm)

        count_inc = self.count + 1
        bc1 = np.float32(1) - np.float32(B1) ** np.float32(count_inc)
        bc2 = np.float32(1) - np.float32(B2) ** np.float32(count_inc)
        step_size = -self.schedule(self.count)
        divisors = torch.tensor([g_norm, bc1, bc2], dtype=torch.float32).to(dev)
        by_dtype: Dict[torch.dtype, torch.Tensor] = {}

        def div(dtype):  # the divisors in `dtype`, as JAX's astype casts them
            if dtype not in by_dtype:
                by_dtype[dtype] = divisors.to(dtype)
            return by_dtype[dtype]

        wd, max_norm = self.cfg.weight_decay, self.cfg.max_grad_norm
        for path, g in grads.items():
            p, mu, nu = params[path], self.mu[path], self.nu[path]
            for idx, gi in _slices(p, g):
                pi, mi, ni = p[idx], mu[idx], nu[idx]
                if clip:
                    gi = (gi / div(gi.dtype)[0]) * _weak(max_norm, gi.dtype)
                mi.copy_(_weak(1 - B1, gi.dtype) * gi + _weak(B1, mi.dtype) * mi)
                ni.copy_(_weak(1 - B2, gi.dtype) * (gi * gi) + _weak(B2, ni.dtype) * ni)
                mu_hat = mi / div(mi.dtype)[1]
                nu_hat = ni / div(ni.dtype)[2]
                u = mu_hat / (torch.sqrt(nu_hat) + _weak(EPS, nu_hat.dtype))
                u = u + _weak(wd, pi.dtype) * pi
                pi.copy_(pi + _weak(step_size, u.dtype) * u)
                if isinstance(g, list):
                    g[idx] = None
        if self.acc is not None:
            for acc in self.acc.values():
                acc.zero_()
        self.count = count_inc
        return True


def make_optimizer(cfg: TrainConfig, params: Dict) -> AdamW:
    """The chain over `params`' trainable leaves (frozen ones are not in it)."""
    mask = dict(tree_leaves(trainable_mask(params, cfg)))
    return AdamW(cfg, {path: t for path, t in tree_leaves(params) if mask[path]})


def fsdp_shardings(params: Dict, mesh: DataMesh) -> Dict:
    """ZeRO-3 layout: each leaf split over 'data' along its largest dim the
    world size divides (ties in np.argsort's order, as the JAX package
    picks them); a scalar, or a leaf no dim of which divides, stays whole."""
    n = mesh.size

    def spec(x) -> PartitionSpec:
        shape = tuple(x.shape)
        for d in list(np.argsort(shape)[::-1]):
            if shape[d] % n == 0 and shape[d] >= n:
                parts = [None] * len(shape)
                parts[d] = "data"
                return PartitionSpec(*parts)
        return PartitionSpec()

    return tree_from_leaves((path, spec(t)) for path, t in tree_leaves(params))


def _shard_dim(spec: PartitionSpec) -> Optional[int]:
    return spec.index("data") if "data" in spec else None


def _buckets(tensors: Dict[Path, torch.Tensor]) -> Iterator[List[Path]]:
    """The paths of `tensors` grouped by dtype, in order (one flat buffer each)."""
    by_dtype: Dict[torch.dtype, List[Path]] = {}
    for path, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(path)
    yield from by_dtype.values()


class VLATrainer:
    """run_vla_training (the reference's base_strategy.py:106+): next-token
    CE over the action tokens through the whole multimodal model. The
    trainer keeps `params`' tensors as its own and updates them in place
    (under fsdp with more than one rank it keeps its shards instead)."""

    def __init__(
        self,
        params: Dict,
        model_cfg: VLAConfig,
        train_cfg: TrainConfig,
        mesh: Optional[DataMesh] = None,
        metrics: Optional[VLAMetrics] = None,
        device="cuda",
    ) -> None:
        if train_cfg.strategy not in ("ddp", "fsdp"):
            raise ValueError(f"unknown strategy {train_cfg.strategy}")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device.type)
        self.metrics = metrics

        leaves = {path: t.detach().to(self.device) for path, t in tree_leaves(params)}
        if self.mesh.size > 1:
            replicate(leaves, self.mesh)
        self.trainable = dict(tree_leaves(trainable_mask(params, train_cfg)))
        self.dims: Dict[Path, Optional[int]] = {path: None for path in leaves}
        if train_cfg.strategy == "fsdp" and self.mesh.size > 1:
            specs = dict(tree_leaves(fsdp_shardings(params, self.mesh)))
            self.dims = {path: _shard_dim(specs[path]) for path in leaves}
            leaves = {path: self._own_shard(t, self.dims[path]) for path, t in leaves.items()}
        self.shards = leaves
        self.optimizer = make_optimizer(train_cfg, self.params)

    @property
    def params(self) -> Dict:
        """The tree of what this rank keeps: every whole leaf, or its shards."""
        return tree_from_leaves(self.shards.items())

    def _own_shard(self, t: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None:
            return t
        n = t.shape[d] // self.mesh.size
        return t.narrow(d, self.mesh.rank * n, n).clone()

    def _gather(self) -> Dict[Path, torch.Tensor]:
        """Every leaf whole: the sharded ones all-gathered, one flat buffer
        a dtype."""
        full = dict(self.shards)
        sharded = {p: t for p, t in self.shards.items() if self.dims[p] is not None}
        for paths in _buckets(sharded):
            flat = torch.cat([sharded[p].reshape(-1) for p in paths])
            parts = [torch.empty_like(flat) for _ in range(self.mesh.size)]
            dist.all_gather(parts, flat, group=self.mesh.group)
            off = 0
            for p in paths:
                shard = sharded[p]
                n = shard.numel()
                full[p] = torch.cat([part[off : off + n].view(shard.shape) for part in parts], dim=self.dims[p])
                off += n
        return full

    def full_params(self) -> Dict:
        """The whole tree (a collective under fsdp: every rank must call it)."""
        return tree_from_leaves(self._gather().items())

    def _all_reduce_grads(self, grads: Dict[Path, object]) -> Dict[Path, torch.Tensor]:
        """Every gradient summed over the ranks (one flat buffer a dtype);
        a sharded leaf's cut to this rank's shard."""
        whole = {p: torch.stack(g) if isinstance(g, list) else g for p, g in grads.items()}
        out = {}
        for paths in _buckets(whole):
            flat = all_reduce_sum(torch.cat([whole[p].reshape(-1) for p in paths]), self.mesh)
            off = 0
            for p in paths:
                n = whole[p].numel()
                out[p] = self._own_shard(flat[off : off + n].view(whole[p].shape), self.dims[p])
                off += n
        return out

    def compute_grads(self, batch: AttackBatch) -> Tuple[torch.Tensor, Dict[Path, object]]:
        """(the global batch's CE mean, the trainable leaves' gradients summed
        over the ranks) for a batch of this rank's rows on the device."""
        full = self._gather()
        leaves, units = {}, {}
        for path, t in full.items():
            if not self.trainable[path]:
                leaves[path] = t
            elif path[:-1] in LAYER_STACKS:
                leaves[path] = units[path] = [t[i].detach().requires_grad_() for i in range(t.shape[0])]
            else:
                leaves[path] = units[path] = t.detach().requires_grad_()
        mcfg = self.model_cfg
        pixels = dual_normalize(batch.images).to(torch_dtype(mcfg))
        logits = vla_forward(tree_from_leaves(leaves.items()), mcfg, batch.input_ids,
                             batch.attention_mask, pixels).logits
        nll, n_valid = ce_sums(logits, batch.labels)
        reduce = (lambda t: all_reduce_sum(t, self.mesh)) if self.mesh.size > 1 else None
        sums = global_sums({"nll": nll, "n_valid": n_valid}, reduce)
        loss = sums["nll"] / sums["n_valid"].clamp(min=1.0)
        del full, leaves, logits
        loss.backward()
        grads = {p: [t.grad for t in u] if isinstance(u, list) else u.grad for p, u in units.items()}
        del units
        if self.mesh.size > 1:
            grads = self._all_reduce_grads(grads)
        return loss.detach(), grads

    def apply_gradients(self, grads: Dict[Path, object]) -> bool:
        """The optimizer's call on `grads`; whether it applied an update."""
        sharded = frozenset(p for p in grads if self.dims[p] is not None)
        reduce = (lambda t: all_reduce_sum(t, self.mesh)) if sharded else None
        return self.optimizer.update(self.shards, grads, sharded, reduce)

    def place(self, batch) -> AttackBatch:
        """A global numpy batch -> this rank's rows on the device."""
        if self.mesh.size > 1:
            batch = shard_batch(batch, self.mesh)
        return batch_to_device(batch, self.device)

    def step(self, batch) -> torch.Tensor:
        """One train step on a global batch; its loss (before the update)."""
        loss, grads = self.compute_grads(self.place(batch))
        self.apply_gradients(grads)
        return loss

    def run_training(self, batches: Iterator, num_steps: Optional[int] = None) -> float:
        steps = num_steps or self.cfg.max_steps
        last_loss = None
        for _ in range(steps):
            last_loss = float(self.step(next(batches)))
            if self.metrics is not None:
                self.metrics.commit(loss=last_loss, update_step_time=True)
                self.metrics.push()
        return last_loss
