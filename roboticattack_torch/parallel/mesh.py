"""The data axis of the data-parallel attack and the (data, model) grid of
tensor- and data-parallel serving (the JAX package's `parallel/mesh.py`).

JAX runs one program over a device mesh; here each rank is a process that
holds its rows of the batch, the whole patch and all the weights:
  batch sharded over 'data'     -> `shard_batch`: rank r keeps rows
                                   [r B/W, (r+1) B/W);
  dist.broadcast(patch, src=0)  -> `replicate`;
  the gradient all-reduce       -> `all_reduce_sum` of the patch gradient;
  gathered per-example metrics  -> `all_gather_rows`.

Serving (`make_serving_mesh`) lays the ranks out as JAX reshapes its
devices, (data, model): rank = d * tp + m. Replica d is the tp consecutive
ranks d*tp .. d*tp+tp-1 (its tensor-parallel group); the ranks with the
same m form a data-parallel group. GSPMD inserts the serving collectives
in JAX; here `ServingMesh` calls them explicitly.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import not_ported
from . import distributed


class DataMesh(NamedTuple):
    """One data axis over every rank of the process group."""

    group: Any
    rank: int
    size: int
    device: torch.device


def make_mesh(data=None, model: int = 1, device: str = "cuda") -> DataMesh:
    """The data axis over the initialized process group (a world of one,
    formed on `device`, if there is none)."""
    if model != 1:
        raise not_ported("make_mesh(model > 1), the attack step under a model axis",
                         "A6c: the attack under a model axis")
    info = distributed.current() or distributed.initialize_multihost(device=device)
    size = dist.get_world_size()
    if data is not None and data != size:
        raise ValueError(f"make_mesh(data={data}) over a process group of {size} ranks")
    return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=info.device)


class ServingMesh(NamedTuple):
    """A dp x tp serving grid over the process group: this rank's place in
    it, its device, and the groups its collectives run over (None for a
    group of one rank: such a collective is skipped)."""

    tp: int
    dp: int
    rank: int
    device: torch.device
    tp_group: Any = None
    dp_group: Any = None

    @property
    def m(self) -> int:
        """This rank's index on the model axis."""
        return self.rank % self.tp

    @property
    def d(self) -> int:
        """This rank's replica (index on the data axis)."""
        return self.rank // self.tp

    @property
    def world(self) -> int:
        return self.tp * self.dp

    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over this replica's tensor-parallel ranks, in place."""
        if self.tp > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.tp_group)
        return t

    def tp_max(self, t: torch.Tensor) -> torch.Tensor:
        """`t`'s elementwise maximum over this replica's tensor-parallel
        ranks, in place."""
        if self.tp > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.tp_group)
        return t

    def tp_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor-parallel ranks' `t` concatenated on the last dim in
        rank order (the vocab-split logits back to the whole row)."""
        if self.tp == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t.contiguous(), group=self.tp_group)
        return torch.cat(parts, dim=-1)

    def any_rank(self, flag: bool) -> bool:
        """True iff `flag` is true on any rank of the world (a MAX
        all-reduce; every rank must call it)."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def _env_world() -> int:
    value = os.environ.get("WORLD_SIZE")
    return int(value) if value else 1


def make_serving_mesh(tp: int = 1, dp: int = 1, device: str = "cuda") -> Optional[ServingMesh]:
    """The one dp x tp serving grid behind `--tp/--dp` on cli.serve and
    cli.eval_libero: None for 1 x 1; otherwise joins the process group
    (`initialize_multihost`: torchrun's environment, a card per local rank
    or gloo when ranks share one) and builds the tensor- and data-parallel
    groups. Every rank must call it. Raises ValueError, before joining
    anything, unless the world holds exactly dp * tp processes."""
    if tp < 1 or dp < 1:
        raise ValueError(f"--tp {tp} / --dp {dp}: both must be >= 1")
    if tp == 1 and dp == 1:
        return None
    need = tp * dp
    have = dist.get_world_size() if dist.is_initialized() else _env_world()
    if have != need:
        raise ValueError(
            f"--dp {dp} x --tp {tp} needs a world of {need} processes; this one has {have}. "
            f"Launch it with `torchrun --nproc_per_node {need} -m ...`"
        )
    info = distributed.current() or distributed.initialize_multihost(device=device)
    rank = dist.get_rank()
    # every rank creates every group, in the same order (dist.new_group)
    tp_groups = [dist.new_group([d * tp + m for m in range(tp)]) if tp > 1 else None for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + m for d in range(dp)]) if dp > 1 else None for m in range(tp)]
    return ServingMesh(tp=tp, dp=dp, rank=rank, device=info.device,
                       tp_group=tp_groups[rank // tp], dp_group=dp_groups[rank % tp])


def batch_sharding(mesh) -> tuple:
    """The PartitionSpec of a batch: its leading dim split over 'data'.
    JAX returns a NamedSharding on `mesh`; a rank here finds its place in
    its own mesh, so the spec does not depend on the argument, which keeps
    the JAX signature."""
    from .sharding import PartitionSpec

    return PartitionSpec("data")


def replicated(mesh) -> tuple:
    """The PartitionSpec of a replicated tensor (the argument as in
    batch_sharding)."""
    from .sharding import PartitionSpec

    return PartitionSpec()


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def row_range(rows: int, mesh: DataMesh) -> slice:
    """This rank's rows of a global batch of `rows`."""
    if rows % mesh.size:
        raise ValueError(f"a batch of {rows} rows does not split evenly over {mesh.size} ranks")
    n = rows // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(batch, mesh: DataMesh):
    """Every array of a batch (numpy or torch, any tuple / dict tree) cut to
    this rank's rows of its leading dim."""
    return _tree_map(lambda x: x[row_range(x.shape[0], mesh)], batch)


def replicate(tree, mesh: DataMesh):
    """Every tensor of `tree` overwritten in place by rank 0's."""

    def bcast(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0, group=mesh.group)
        return t

    return _tree_map(bcast, tree)


def broadcast_object(obj, mesh: DataMesh):
    """Rank 0's picklable `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """`t` summed over the ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's `t` concatenated on dim 0 in rank order: the global
    batch's rows."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def process_zero() -> bool:
    """The rank-0 gate of every file write (UADA_ddp.py:229-231); true in a
    process without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def patch_digest(patch) -> str:
    """SHA-256 of a patch's float32 bytes, to see that replicas agree."""
    import hashlib

    arr = patch.detach().cpu().numpy() if isinstance(patch, torch.Tensor) else np.asarray(patch)
    return hashlib.sha256(np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()
