"""Tracing and wall-clock step timing (the JAX package's
`utils/profiling.py`). `maybe_trace` records a block with torch.profiler
into one Chrome trace per rank; StepTimer's caller ends each timed step with
a device synchronize; `counting_collectives` records each collective a block
makes, with its bytes and host seconds (parallel/evidence.py's inventory)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, NamedTuple, Optional


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block when `trace_dir` is set: host activity, and the
    card's kernels where CUDA is available, written as
    <trace_dir>/trace_rank<r>.json (Chrome trace format; r is the process
    group rank, 0 without one)."""
    if not trace_dir:
        yield
        return
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}")


class StepTimer:
    """Wall-clock per-step timing with a percentile summary."""

    def __init__(self) -> None:
        self.samples = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "steps": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "min_s": s[0],
        }


# the collectives the port calls, recorded with their tensor
COUNTED = ("all_reduce", "all_gather", "broadcast")
# every other collective of torch.distributed: recorded by name, or refused
OTHER_COLLECTIVES = (
    "all_gather_into_tensor", "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "batch_isend_irecv", "broadcast_object_list", "gather", "gather_object", "irecv", "isend",
    "monitored_barrier", "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send",
)


class Collective(NamedTuple):
    """One collective call of this process."""

    name: str  # the torch.distributed function: all_reduce, all_gather, broadcast, or another
    op: Optional[str]  # an all_reduce's op (SUM, MAX, ...), else None
    ranks: Any  # the group's ranks (a tuple), or "world" without a group
    shape: tuple  # the tensor this rank gives (another collective's first tensor argument, or ())
    dtype: str
    nbytes: int  # of that tensor
    seconds: float  # host clock around the call; a CUDA tensor's card synchronized before and after


def _given_tensor(name: str, a: tuple, k: dict):
    """The tensor this rank gives to collective `name`: all_gather's second
    argument, else the first tensor among the arguments (or in a list of
    them), or None."""
    import torch

    if name == "all_gather":
        return a[1]
    for x in list(a) + list(k.values()):
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            if isinstance(t, torch.Tensor):
                return t
    return None


@contextlib.contextmanager
def counting_collectives(log: list) -> Iterator[list]:
    """Append a Collective to `log` for every collective of torch.distributed
    this process makes while the block runs: dist.all_reduce / all_gather /
    broadcast (COUNTED) with their tensor, any of OTHER_COLLECTIVES by name
    (with its first tensor argument, if any). The functions are replaced
    on torch.distributed for the block, so every caller that looks them up
    at call time is seen. A CUDA tensor's card is synchronized before the
    call, so its seconds leave out the work queued before it."""
    import torch
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in COUNTED + OTHER_COLLECTIVES if hasattr(dist, n)}

    def wrap(name):
        def call(*a, **k):
            t = _given_tensor(name, a, k)
            group = k.get("group")
            ranks = tuple(dist.get_process_group_ranks(group)) if group is not None else "world"
            op = str(k.get("op", dist.ReduceOp.SUM)).split(".")[-1] if name == "all_reduce" else None
            cuda = t is not None and t.is_cuda
            if cuda:
                torch.cuda.synchronize(t.device)
            start = time.perf_counter()
            out = saved[name](*a, **k)
            if cuda:
                torch.cuda.synchronize(t.device)
            shape, dtype, nbytes = ((), "", 0) if t is None else \
                (tuple(t.shape), str(t.dtype), t.numel() * t.element_size())
            log.append(Collective(name, op, ranks, shape, dtype, nbytes, time.perf_counter() - start))
            return out
        return call

    for n in saved:
        setattr(dist, n, wrap(n))
    try:
        yield log
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
