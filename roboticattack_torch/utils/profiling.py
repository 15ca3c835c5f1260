"""Tracing and wall-clock step timing (the JAX package's
`utils/profiling.py`). `maybe_trace` records a block with torch.profiler
into one Chrome trace per rank; StepTimer's caller ends each timed step with
a device synchronize."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


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
