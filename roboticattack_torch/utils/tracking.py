"""Metric tracking: JSONL (always) + wandb (optional) + stdout (the JAX
package's `utils/tracking.py`). In a process group only rank 0 tracks: a
tracker built on another rank writes, logs and prints nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from ..parallel.mesh import process_zero


class Tracker:
    def __init__(
        self,
        run_dir: str,
        run_name: str = "run",
        wandb_project: str = "false",
        wandb_entity: Optional[str] = None,
        tags: Optional[list] = None,
        config: Optional[Dict] = None,
        quiet: bool = False,
    ) -> None:
        self.run_dir = run_dir
        self.enabled = process_zero()
        self.writes = 0  # JSONL lines this process wrote
        self.quiet = quiet
        self._t0 = time.time()
        self._wandb = None
        self._jsonl = None
        if not self.enabled:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "run-metrics.jsonl"), "a")
        if wandb_project and wandb_project != "false":
            try:
                import wandb

                self._wandb = wandb.init(
                    entity=wandb_entity, project=wandb_project, name=run_name,
                    tags=tags, config=config or {},
                )
            except ImportError:
                print("[tracker] wandb requested but not installed; JSONL only")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        payload = {"step": step, "elapsed_s": round(time.time() - self._t0, 3)}
        payload.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        self.writes += 1
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if not self.quiet:
            head = ", ".join(f"{k}={float(v):.5g}" for k, v in list(metrics.items())[:5])
            print(f"[step {step}] {head}")

    def log_images(self, key: str, paths: list, step: int) -> None:
        """Image files to wandb under `key` (nothing without wandb)."""
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: [wandb.Image(p) for p in paths]}, step=step)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
