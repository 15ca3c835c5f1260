"""The (data, model) grid of the attack step and of tensor- and
data-parallel serving (the JAX package's `parallel/mesh.py`).

JAX runs one program over a device mesh; here each rank is a process. Both
grids lay the ranks out as JAX reshapes its devices, (data, model): rank =
d * tp + m. Replica d is the tp consecutive ranks d*tp .. d*tp+tp-1 (its
model, or tensor-parallel, group); the ranks with the same m form a data
group. On the data axis each rank holds its replica's rows of the batch and
the whole patch:
  batch sharded over 'data'     -> `shard_batch`: replica d keeps rows
                                   [d B/dp, (d+1) B/dp);
  dist.broadcast(patch, src=0)  -> `replicate`;
  the gradient all-reduce       -> `all_reduce_sum` of the patch gradient
                                   over the data group;
  gathered per-example metrics  -> `all_gather_rows` over the data group.
On the model axis (`make_mesh(model > 1)`) each rank holds its slice of the
decoder's weights (parallel/sharding.py `shard_params`) and the forward and
backward call the Megatron collectives of parallel/tensor_parallel.py on
the model group. GSPMD inserts both in JAX; here they are explicit.

Serving (`make_serving_mesh`) builds the same grid (`grid_mesh`, which the
audit of parallel/evidence.py builds too); `ServingMesh` carries the
decode's collectives. Both axes' model-group sums and maxima go
through `model_all_reduce`.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import distributed


class DataMesh(NamedTuple):
    """This rank's place in a (data, model) grid of the world's ranks:
    `group` / `rank` / `size` are the data axis (the data group, the
    replica index d and dp) that the data helpers below cut and reduce
    over; `model_group` / `m` / `tp` the model axis (None, 0 and 1 without
    one)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    model_group: Any = None
    m: int = 0
    tp: int = 1

    @property
    def d(self) -> int:
        """This rank's replica (index on the data axis)."""
        return self.rank

    @property
    def dp(self) -> int:
        return self.size


def make_mesh(data=None, model: int = 1, device: str = "cuda") -> DataMesh:
    """The (data, model) grid over the initialized process group (a world
    of one, formed on `device`, if there is none and model is 1). `data`
    defaults to the world over `model`. With model > 1 every rank must call
    it: it creates the model and data groups, and raises ValueError, before
    joining anything, unless the world holds exactly data * model
    processes."""
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"make_mesh(data={data}, model={model}): both must be >= 1")
    if model == 1:
        info = distributed.current() or distributed.initialize_multihost(device=device)
        size = dist.get_world_size()
        if data is not None and data != size:
            raise ValueError(f"make_mesh(data={data}) over a process group of {size} ranks")
        return world_mesh(info.device)
    dp = _world() // model if data is None else data
    return _grid(dp, model, device, f"make_mesh(data={data}, model={model}) needs a world of data x model processes")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else _env_world()


def _grid(dp: int, tp: int, device: str, asked: str) -> DataMesh:
    """The dp x tp grid of both make_mesh and make_serving_mesh, rank = d *
    tp + m: joins the process group (`initialize_multihost`: torchrun's
    environment, a card per local rank or gloo when ranks share one) and
    creates every model and data group, on every rank in the same order
    (dist.new_group). ValueError `asked`, before joining anything, unless
    the world holds exactly dp * tp processes."""
    have, need = _world(), dp * tp if dp else tp
    if dp * tp != have:
        raise ValueError(f"{asked}; this one has {have}. Launch it with `torchrun --nproc_per_node {need}`")
    info = distributed.current() or distributed.initialize_multihost(device=device)
    return grid_mesh(dp, tp, info.device)


def world_mesh(device) -> DataMesh:
    """A data axis over the whole initialized process group and no model
    axis: make_mesh(model=1)'s grid."""
    return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=dist.get_world_size(),
                    device=torch.device(device))


def grid_mesh(dp: int, tp: int, device) -> DataMesh:
    """This rank's place in the dp x tp grid over the initialized process
    group of dp * tp ranks (rank = d * tp + m): creates every model group,
    then every data group, on every rank in the same order
    (dist.new_group). The one layout of make_mesh, make_serving_mesh and
    the audit (parallel/evidence.py)."""
    rank = dist.get_rank()
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    return DataMesh(group=data_groups[rank % tp], rank=rank // tp, size=dp, device=torch.device(device),
                    model_group=model_groups[rank // tp], m=rank % tp, tp=tp)


def model_all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced by `op` over `mesh`'s model group in place (a DataMesh
    or a ServingMesh; nothing to do without a model axis): the model-axis
    sum and max of the attack step (parallel/tensor_parallel.py) and of
    the serving decode."""
    if mesh.tp > 1:
        dist.all_reduce(t, op=op, group=mesh.model_group)
    return t


class ServingMesh(NamedTuple):
    """A dp x tp serving grid over the process group (make_mesh's, with
    `rank` the world rank): this rank's place in it, its device, and the
    groups its collectives run over (a model-axis collective is skipped at
    tp 1)."""

    tp: int
    dp: int
    rank: int
    device: torch.device
    model_group: Any = None
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
        return model_all_reduce(t, self)

    def tp_max(self, t: torch.Tensor) -> torch.Tensor:
        """`t`'s elementwise maximum over this replica's tensor-parallel
        ranks, in place."""
        return model_all_reduce(t, self, dist.ReduceOp.MAX)

    def tp_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor-parallel ranks' `t` concatenated on the last dim in
        rank order (the vocab-split logits back to the whole row)."""
        if self.tp == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t.contiguous(), group=self.model_group)
        return torch.cat(parts, dim=-1)

    def any_rank(self, flag: bool) -> bool:
        """True iff `flag` is true on any rank of the world (a MAX
        all-reduce; every rank must call it). On the meta device (the
        audit, parallel/evidence.py) the all-reduce is issued and there is
        nothing to read: True."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return True if t.is_meta else bool(t.item())


def _env_world() -> int:
    value = os.environ.get("WORLD_SIZE")
    return int(value) if value else 1


def make_serving_mesh(tp: int = 1, dp: int = 1, device: str = "cuda") -> Optional[ServingMesh]:
    """The one dp x tp serving grid behind `--tp/--dp` on cli.serve and
    cli.eval_libero: None for 1 x 1; otherwise the grid of make_mesh
    (`_grid`) as a ServingMesh. Every rank must call it. Raises ValueError,
    before joining anything, unless the world holds exactly dp * tp
    processes."""
    if tp < 1 or dp < 1:
        raise ValueError(f"--tp {tp} / --dp {dp}: both must be >= 1")
    if tp == 1 and dp == 1:
        return None
    return serving_mesh(_grid(dp, tp, device, f"--dp {dp} x --tp {tp} needs a world of {dp * tp} processes"))


def serving_mesh(grid: DataMesh) -> ServingMesh:
    """The ServingMesh of a grid_mesh: the same rank's place and groups."""
    return ServingMesh(tp=grid.tp, dp=grid.dp, rank=grid.d * grid.tp + grid.m, device=grid.device,
                       model_group=grid.model_group, dp_group=grid.group)


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
    """This rank's rows of a global batch of `rows`: its replica's, the
    same on every rank of a model group."""
    if rows % mesh.size:
        raise ValueError(f"a batch of {rows} rows does not split evenly over {mesh.size} replicas")
    n = rows // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(batch, mesh: DataMesh):
    """Every array of a batch (numpy or torch, any tuple / dict tree) cut to
    this rank's rows of its leading dim."""
    return _tree_map(lambda x: x[row_range(x.shape[0], mesh)], batch)


def replicate(tree, mesh: DataMesh):
    """Every tensor of `tree` overwritten in place by rank 0's, on every
    rank of the world (both axes of the grid)."""

    def bcast(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0)
        return t

    return _tree_map(bcast, tree)


def broadcast_object(obj, mesh: DataMesh):
    """Rank 0's picklable `obj` on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """`t` summed over the data group, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every replica's `t` concatenated on dim 0 in replica order (over the
    data group): the global batch's rows."""
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
