"""Batch evaluation queue over the four LIBERO suites.

Equivalent of the reference's evaluation_tool/eval_queue_single_four_spec.py:
fixed per-suite patch placements (:22-29), skip-if-done marker files
(:38-40,65-67), and a bounded worker pool launching one eval per suite
(:90-99). On a one-card host the pool defaults to 1 concurrent eval (the
policy owns the card). The markers and resume rules are the JAX package's;
each eval runs `python -m roboticattack_torch.cli.eval_libero`.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

# eval_queue_single_four_spec.py:22-29
SUITE_PLACEMENTS: Dict[str, Tuple[int, int]] = {
    "libero_10": (5, 160),
    "libero_object": (30, 150),
    "libero_goal": (15, 158),
    "libero_spatial": (120, 160),
}


def marker_path(output_dir: str, suite: str, pos: Tuple[int, int],
                angle: int = 0, shx: int = 0, shy: int = 0) -> str:
    """The reference's run-id marker: `EVAL-<suite>--<x>_<y>_<angle>_<shx>_<shy>.txt`
    (eval_queue_single_four_spec.py:36-39). eval_libero writes this file
    itself (reference: run_libero_eval_args_geo_batch.py:130-135), so
    reference-tool resumes see our runs and vice versa."""
    return os.path.join(
        output_dir, f"EVAL-{suite}--{pos[0]}_{pos[1]}_{angle}_{shx}_{shy}.txt"
    )


def organize_experiments(
    patch_by_suite: Dict[str, str], output_dir: str,
    placements: Optional[Dict[str, Tuple[int, int]]] = None,
    angle: int = 0, shx: int = 0, shy: int = 0,
) -> List[Dict]:
    """Build the pending task list, skipping suites whose marker file exists.

    Resume semantics: the reference skips on mere file EXISTENCE
    (eval_queue_single_four_spec.py:38-40), which also skips crashed runs.
    The eval creates its episode log at start, so existence alone can't
    distinguish complete from interrupted; we additionally require the
    completion sentinel run_task appends after a zero exit — an interrupted
    or killed run (even one where run_task's cleanup never executed, e.g.
    Ctrl-C in the parent) is therefore always retried. Reference-made logs
    (no sentinel) are retried too — the safe direction."""
    placements = placements or SUITE_PLACEMENTS
    tasks = []
    for suite, patch in patch_by_suite.items():
        pos = placements[suite]
        marker = marker_path(output_dir, suite, pos, angle, shx, shy)
        if os.path.exists(marker) and _is_complete(marker):
            print(f"skip {suite}: completed marker exists ({marker})")
            continue
        tasks.append(dict(suite=suite, patch=patch, x=pos[0], y=pos[1],
                          angle=angle, shx=shx, shy=shy, marker=marker))
    return tasks


COMPLETE_SENTINEL = "# queue-complete"


def _is_complete(marker: str) -> bool:
    try:
        with open(marker) as f:
            return COMPLETE_SENTINEL in f.read()
    except OSError:
        return False


def run_task(task: Dict, output_dir: str, checkpoint: Optional[str],
             num_trials: int, extra_args: Optional[List[str]] = None) -> int:
    """Launch one suite eval as a subprocess; stamp the marker complete on
    success. Geometry goes through task['angle'/'shx'/'shy'] (from
    organize_experiments) so the eval's log filename and our marker path are
    the SAME file — passing --angle via extra_args would silently desync
    them and break resume."""
    cmd = [
        sys.executable, "-m", "roboticattack_torch.cli.eval_libero",
        "--task_suite_name", task["suite"],
        "--patchroot", task["patch"],
        "--x", str(task["x"]), "--y", str(task["y"]),
        "--angle", str(task.get("angle", 0)),
        "--shx", str(task.get("shx", 0)), "--shy", str(task.get("shy", 0)),
        "--num_trials_per_task", str(num_trials),
        "--output", output_dir,
    ]
    if checkpoint:
        cmd += ["--checkpoint", checkpoint]
    cmd += extra_args or []
    print("launch:", " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc == 0:
        with open(task["marker"], "a") as f:
            f.write(COMPLETE_SENTINEL + "\n")
    return rc


def run_queue(
    patch_by_suite: Dict[str, str],
    output_dir: str,
    checkpoint: Optional[str] = None,
    num_trials: int = 50,
    max_concurrent: int = 1,
    extra_args: Optional[List[str]] = None,
    angle: int = 0, shx: int = 0, shy: int = 0,
) -> Dict[str, int]:
    os.makedirs(output_dir, exist_ok=True)
    tasks = organize_experiments(patch_by_suite, output_dir,
                                 angle=angle, shx=shx, shy=shy)
    results: Dict[str, int] = {}
    with ThreadPoolExecutor(max_workers=max_concurrent) as pool:
        futures = {
            pool.submit(run_task, t, output_dir, checkpoint, num_trials, extra_args): t
            for t in tasks
        }
        for fut, t in futures.items():
            results[t["suite"]] = fut.result()
    return results
