"""Metric tracking: JSONL (always) + wandb (optional) + stdout (the JAX
package's `utils/tracking.py`)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.quiet = quiet
        self._jsonl = open(os.path.join(run_dir, "run-metrics.jsonl"), "a")
        self._t0 = time.time()
        self._wandb = None
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
        payload = {"step": step, "elapsed_s": round(time.time() - self._t0, 3)}
        payload.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if not self.quiet:
            head = ", ".join(f"{k}={float(v):.5g}" for k, v in list(metrics.items())[:5])
            print(f"[step {step}] {head}")

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
