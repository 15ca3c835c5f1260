#!/usr/bin/env python3
"""The readings that a sparse-expert cell's correctness limits are set
from: `calibrate.py`'s, and faults of the sparse-expert layer that the
limits have to fail too.

    python3 vlabench/calibrate_moe.py --workload <cell> --seeds 12 --control-seeds 3 --first-seed <n>

For each seed, as `calibrate.py`: the program's first outer step against
the float32 reference (`program`), and for the first `--control-seeds`
the float8 control (`control`) and the half-batch fault (`half_batch`);
for those seeds also each fault of `reference/moe.py` (`no_shared_experts`:
the shared experts left out; `routed_scale_1`: routed_scaling_factor taken
as 1; `unbiased_routing`: the choice made without the correction bias),
the reference with the fault put in the program's place. Every reference
runs its experts on the program's expert choice, and each one's own choice
at the first sparse layer stands in for the program's in `route_miss`
(the driver's `readings`). Every set of readings is put through the
comparison that decides `correct`, with the cell's limits as they are when
it runs. Prints one JSON line per seed and a summary line.
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

from vlabench import calibrate, run  # noqa: E402
from vlabench.reference import compare  # noqa: E402
from vlabench.reference import moe as ref_moe  # noqa: E402
from vlabench.reference import vla as ref  # noqa: E402

KINDS = ("program", "control", "half_batch") + ref_moe.FAULTS


def readings(workload: str, seed: int, controls: bool, device: str = "cuda", config_override=None) -> dict:
    cell, cfg, traffic = run.cell_files(workload)
    driver = run.load_module("drivers", cell["driver"]).Driver(config_override or cfg, traffic, cell, seed,
                                                               torch.device(device))
    driver.setup()
    driver.release()
    exact = driver.reference()
    out = {"seed": seed, "program": driver.readings(driver.first, exact)}
    if controls:
        others = {"control": driver.reference(ref.Precision(fp8=True)),
                  "half_batch": driver.reference(rows=traffic["batch_size"] // 2)}
        others.update((fault, driver.reference(fault=fault)) for fault in ref_moe.FAULTS)
        for kind, trace in others.items():
            out[kind] = driver.readings(dict(calibrate.as_first(driver.first, trace), chosen=trace.chosen), exact)
    out["correct"] = {kind: compare.holds(compare.held(out[kind], cell["limits"])) for kind in KINDS if kind in out}
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
    for kind in KINDS[1:]:
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: min(g[k] for g in got) for k in got[0]}
    summary["correct"] = {kind: sorted({r["correct"][kind] for r in rows if kind in r["correct"]}) for kind in KINDS}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
