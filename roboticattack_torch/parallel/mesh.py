"""The data axis of the data-parallel attack (the JAX package's
`parallel/mesh.py`, the names the attack uses).

JAX runs one program over a device mesh; here each rank is a process that
holds its rows of the batch, the whole patch and all the weights:
  batch sharded over 'data'     -> `shard_batch`: rank r keeps rows
                                   [r B/W, (r+1) B/W);
  dist.broadcast(patch, src=0)  -> `replicate`;
  the gradient all-reduce       -> `all_reduce_sum` of the patch gradient;
  gathered per-example metrics  -> `all_gather_rows`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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
        raise not_ported("make_mesh(model > 1)", "slice 3: TP and DP")
    info = distributed.current() or distributed.initialize_multihost(device=device)
    size = dist.get_world_size()
    if data is not None and data != size:
        raise ValueError(f"make_mesh(data={data}) over a process group of {size} ranks")
    return DataMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=info.device)


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
