"""Wall-clock step timing (the JAX package's `utils/profiling.py` StepTimer).
The caller ends each timed step with a device synchronize."""

from __future__ import annotations

import time


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
