"""The Megatron operators of the attack step under a model axis: what GSPMD
inserts in the JAX package's sharded step (`parallel/sharding.py` there
annotates the weights, XLA adds the collectives), called explicitly here on
the model group of a `parallel.mesh.DataMesh` (rank = d * tp + m).

  copy_to_model     identity forward; the input gradient summed over the
                    model group in the backward. Before a column-parallel
                    product (q/k/v, gate/up, lm_head, projector fc1), whose
                    input gradient each rank holds only in part.
  reduce_from_model the partial values summed over the model group in the
                    forward; identity backward. After a row-parallel product
                    (o, down, projector fc2: this rank's slice of the
                    contraction), in the model dtype, as GSPMD sums the
                    partial products in the JAX package and as the serving
                    decode sums them; and every sum over the vocab slices of
                    the logits, and the embed lookup's.
  vocab_embed       the vocab-split embedding lookup: this rank's rows, zeros
                    elsewhere, summed.

`torch.distributed.nn.functional.all_reduce` is not used: its backward sums
the gradient over the group again, which is wrong after a row-parallel
product (each rank's gradient there is already the whole one).

The vocab-parallel reductions of the objectives (`vocab_token_logprob`,
`vocab_argmax`, `vocab_expectation`) take this rank's [..., V/tp] logits
slice and give every model rank the whole row's value; each rank's backward
reaches its own slice only. Without a model axis (mesh None, or tp 1) each
is the plain operation on whole rows. No collective here moves a weight or a
whole logits row: the row statistics are [..., rows] tensors.

Every collective is looked up on `torch.distributed` at call time, so a
caller that wraps `dist.all_reduce` / `dist.all_gather` sees each one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import model_all_reduce


def split(mesh) -> bool:
    """True when `mesh` has a model axis of more than one rank."""
    return mesh is not None and mesh.tp > 1


def _all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    return model_all_reduce(t.contiguous(), mesh, op)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x itself; its gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh) if split(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the model group; the gradient passed through."""
    return _ReduceFromModel.apply(x, mesh) if split(mesh) else x


def local_count(total: int, mesh, what: str) -> int:
    """This rank's share of `total` (heads, a hidden width) on the model
    axis; ValueError when tp does not divide it."""
    tp = mesh.tp if split(mesh) else 1
    if total % tp:
        raise ValueError(f"{what} = {total} does not split over a model axis of {tp} ranks")
    return total // tp


def vocab_embed(embed: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """embed[ids] from this rank's vocab rows [m V/tp, (m+1) V/tp): the rows
    it holds, zeros for the ids it does not, summed over the model group."""
    if not split(mesh):
        return embed[ids]
    lo = mesh.m * embed.shape[0]
    mine = (ids >= lo) & (ids < lo + embed.shape[0])
    rows = embed[torch.where(mine, ids - lo, torch.zeros_like(ids))]
    return reduce_from_model(rows * mine[..., None].to(rows.dtype), mesh)


def vocab_range(z: torch.Tensor, mesh) -> Tuple[int, int]:
    """[lo, hi): the vocab ids of this rank's logits slice."""
    lo = mesh.m * z.shape[-1]
    return lo, lo + z.shape[-1]


def _row_max(z: torch.Tensor, mesh) -> torch.Tensor:
    """The largest logit of each whole row (no gradient): an all-reduce MAX
    of the slices' maxima."""
    return _all_reduce(z.detach().amax(dim=-1), mesh, dist.ReduceOp.MAX)


def vocab_token_logprob(z: torch.Tensor, idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """log_softmax(z)[..., idx] over whole rows of the vocab: [...]. Split:
    the rows' max, then one sum of [sum exp(z - max), the logit at idx from
    the rank that holds it]."""
    if not split(mesh):
        return torch.gather(torch.log_softmax(z, dim=-1), -1, idx[..., None])[..., 0]
    lo, hi = vocab_range(z, mesh)
    zmax = _row_max(z, mesh)
    mine = (idx >= lo) & (idx < hi)
    picked = torch.gather(z, -1, torch.where(mine, idx - lo, torch.zeros_like(idx))[..., None])[..., 0]
    parts = torch.stack([torch.exp(z - zmax[..., None]).sum(dim=-1), torch.where(mine, picked, 0.0)])
    total = reduce_from_model(parts, mesh)
    return total[1] - zmax - torch.log(total[0])


def _slice_part(z: torch.Tensor, mesh, lo: int, hi: int) -> Tuple[Optional[torch.Tensor], int]:
    """This rank's logits of the vocab ids [lo, hi) and the first id they
    hold, or (None, lo) when it holds none of them."""
    vlo, vhi = vocab_range(z, mesh)
    a, b = max(lo, vlo), min(hi, vhi)
    return (z[..., a - vlo : b - vlo], a) if a < b else (None, lo)


def vocab_argmax(z: torch.Tensor, mesh=None, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
    """The id of the largest logit among the vocab ids [lo, hi) of each row
    (the first on ties, as torch.argmax). Split: each rank's (max, id) of
    its part, one all-gather of the [..., 2] pairs, the first rank with the
    largest max."""
    if not split(mesh):
        return z[..., lo:hi].argmax(dim=-1) + lo
    hi = z.shape[-1] * mesh.tp if hi is None else hi
    part, first = _slice_part(z.detach(), mesh, lo, hi)
    if part is None:
        best = torch.full(z.shape[:-1], float("-inf"), dtype=torch.float32, device=z.device)
        arg = torch.zeros(z.shape[:-1], dtype=torch.long, device=z.device)
    else:
        best, arg = part.float().max(dim=-1)
    pair = torch.stack([best, (arg + first).float()], dim=-1).contiguous()
    pairs = [torch.empty_like(pair) for _ in range(mesh.tp)]
    dist.all_gather(pairs, pair, group=mesh.model_group)
    pairs = torch.stack(pairs)  # [tp, ..., 2]; ids < 2^24 are exact in f32
    rank = pairs[..., 0].argmax(dim=0)
    return torch.gather(pairs[..., 1], 0, rank[None])[0].long()


def vocab_expectation(z: torch.Tensor, lo: int, hi: int, weights: torch.Tensor, mesh=None) -> torch.Tensor:
    """sum_i softmax(z[..., lo:hi])_i * weights[i] over each row. Split: the
    slice's max, then one sum of [sum exp(z - max), sum exp(z - max) *
    weights] over the ranks' parts of the slice."""
    if not split(mesh):
        probs = torch.softmax(z[..., lo:hi], dim=-1)
        return (probs * weights).sum(dim=-1)
    part, first = _slice_part(z, mesh, lo, hi)
    if part is None:
        smax = torch.full(z.shape[:-1], float("-inf"), dtype=z.dtype, device=z.device)
    else:
        smax = part.detach().amax(dim=-1)
    smax = _all_reduce(smax, mesh, dist.ReduceOp.MAX)
    if part is None:
        # zeros on z's graph: this rank's backward runs the model group's
        # collectives as the others' do, though none of its logits counts
        parts = z[..., :0].sum(dim=-1).expand(2, *z.shape[:-1])
    else:
        e = torch.exp(part - smax[..., None])
        w = weights[first - lo : first - lo + part.shape[-1]]
        parts = torch.stack([e.sum(dim=-1), (e * w).sum(dim=-1)])
    total = reduce_from_model(parts, mesh)
    return total[1] / total[0]
