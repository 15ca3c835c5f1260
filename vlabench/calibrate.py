#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, and the
control that has to fail them.

    python3 vlabench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --first-seed <n>

For each seed: the program's first outer step (the cell's own set-up, at
its own sizes) against the float32 reference -> the program's readings,
whose largest over the seeds is a limit's lower end. For the first
`--control-seeds` of them also
- control: the reference computed with float8 e4m3 products in the
  program's place;
- half_batch: the reference on the first half of the batch's rows, the
  mean over those (a fault planted in the reference put in the program's
  place);
each against the float32 reference. Each set of readings is also put
through the comparison that decides `correct`, with the cell's limits: the
program's has to come out correct, the control's and the fault's not. A
step that returns its state unchanged reads 1 on delta_norm_gap and
m_norm_gap by construction and needs no run. Prints one JSON line per seed
and a summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vlabench import run  # noqa: E402
from vlabench.reference import compare  # noqa: E402
from vlabench.reference import vla as ref  # noqa: E402


def as_first(first: dict, trace: ref.AttackTrace) -> dict:
    """A reference trace in the program's place: the program's inputs, its
    losses, patch and moment from the reference."""
    return dict(first, losses=trace.losses, patch=trace.patch.cpu(), m=trace.m.cpu())


def verdicts(row: dict, limits: dict) -> dict:
    """`correct` of each set of readings in `row` under the cell's limits."""
    return {kind: compare.holds(compare.held(row[kind], limits))
            for kind in ("program", "control", "half_batch") if kind in row}


def readings(workload: str, seed: int, controls: bool, device: str = "cuda", config_override=None) -> dict:
    cell, cfg, traffic = run.cell_files(workload)
    driver = run.load_module("drivers", cell["driver"]).Driver(config_override or cfg, traffic, cell, seed,
                                                               torch.device(device))
    driver.setup()
    driver.release()
    exact = driver.reference()
    out = {"seed": seed, "program": compare.attack_readings(driver.first, exact)}
    if controls:
        out["control"] = compare.attack_readings(as_first(driver.first, driver.reference(ref.Precision(fp8=True))),
                                                 exact)
        half = traffic["batch_size"] // 2
        out["half_batch"] = compare.attack_readings(as_first(driver.first, driver.reference(rows=half)), exact)
    out["correct"] = verdicts(out, cell["limits"])
    del driver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    args = ap.parse_args(argv)
    rows = []
    for k in range(args.seeds):
        t = time.perf_counter()
        r = readings(args.workload, args.first_seed + k, k < args.control_seeds)
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
               "lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for kind in ("control", "half_batch"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: min(g[k] for g in got) for k in got[0]}
    summary["correct"] = {kind: sorted({r["correct"][kind] for r in rows if kind in r["correct"]})
                          for kind in ("program", "control", "half_batch")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
