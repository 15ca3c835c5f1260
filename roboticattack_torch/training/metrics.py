"""Training metrics with smoothed windows over the port's tracker (the JAX
package's `training/metrics.py`, after the reference's
prismatic/training/metrics.py VLAMetrics: per-dataset loss windows,
smoothed deques, JSONL + W&B through `utils/tracking.Tracker`)."""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Deque, Dict, Optional

from ..utils.tracking import Tracker


class VLAMetrics:
    def __init__(
        self,
        tracker: Tracker,
        window: int = 128,
        stage: str = "vla-train",
    ) -> None:
        self.tracker = tracker
        self.stage = stage
        self.step = 0
        self.epoch = 0
        self._t0 = time.time()
        self._windows: Dict[str, Deque[float]] = defaultdict(lambda: deque(maxlen=window))
        self._per_dataset: Dict[str, Deque[float]] = defaultdict(lambda: deque(maxlen=window))

    def commit(self, *, loss: Optional[float] = None, lr: Optional[float] = None,
               update_step_time: bool = False, **extra: float) -> None:
        if loss is not None:
            self._windows["loss"].append(float(loss))
        if lr is not None:
            self._windows["lr"].append(float(lr))
        if update_step_time:
            now = time.time()
            self._windows["step_time"].append(now - self._t0)
            self._t0 = now
        for k, v in extra.items():
            self._windows[k].append(float(v))

    def commit_for_dataset(self, dataset_name: str, loss: float) -> None:
        self._per_dataset[dataset_name].append(float(loss))

    def _smoothed(self) -> Dict[str, float]:
        out = {}
        for k, win in self._windows.items():
            if win:
                out[f"{self.stage}/{k}"] = sum(win) / len(win)
        for name, win in self._per_dataset.items():
            if win:
                out[f"{self.stage}/loss_{name}"] = sum(win) / len(win)
        return out

    def push(self) -> Dict[str, float]:
        metrics = self._smoothed()
        metrics[f"{self.stage}/step"] = self.step
        metrics[f"{self.stage}/epoch"] = self.epoch
        self.tracker.log(metrics, step=self.step)
        self.step += 1
        return metrics
