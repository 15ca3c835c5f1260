#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 vlabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is `vlabench/workloads/<cell>.json`
(its configuration, traffic mix, driver and correctness limits); the
configuration is `vlabench/configs/<config>.json`, the traffic mix
`vlabench/traffic/<traffic>.json`, the driver `vlabench/drivers/<driver>.py`
and each per-layer metric `vlabench/metrics/<metric>.py`, all found by the
names in `BENCHMARK.json`. With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from a
device trace of part of the window. Both check the timed path's outputs
against the plain reference once the window has closed.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, or if JAX or the JAX package is loaded by the end.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # set-up is counted from the process's first line

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "vlabench")
FORBIDDEN = ("jax", "jaxlib", "flax", "roboticattack_tpu")

os.environ.update(USE_FLAX="0", USE_JAX="0")
# build and kernel caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """vlabench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"vlabench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those that list the cell, and those without a list whose end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def cell_files(workload: str) -> tuple:
    """(cell, configuration, traffic) of a cell, by name."""
    cell = load_json(HERE, "workloads", workload + ".json")
    return cell, load_json(HERE, "configs", cell["config"] + ".json"), load_json(HERE, "traffic",
                                                                                 cell["traffic"] + ".json")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             config_override: dict | None = None) -> dict:
    """One run of a cell: set-up, the window, the comparison with the
    reference. Returns the result object (without the device entry's card
    facts, which `main` adds). `config_override` replaces the cell's
    configuration (the tests' small ones on the CPU)."""
    import torch

    from vlabench.reference import compare

    bench = load_json(ROOT, "BENCHMARK.json")
    entry = cell_entry(bench, workload)
    cell, cfg, traffic = cell_files(workload)
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"{workload}: the cell file and BENCHMARK.json name different config or traffic")
    driver = load_module("drivers", cell["driver"]).Driver(config_override or cfg, traffic, cell, seed,
                                                           torch.device(device))
    driver.setup()
    setup_s = time.perf_counter() - START
    record = driver.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    driver.release()
    checks = driver.check()
    correct = compare.holds(checks)

    wanted = metrics_of(bench, workload, trace)
    values = {}
    if trace:
        for m in wanted:
            v = load_module("metrics", m["name"]).read(record)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        measured = dict(driver.end_to_end(record), setup_s=setup_s)
        for m in wanted:
            values[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"], "metrics": values,
           "device": {"memory_peak_bytes": peak}}
    if trace:
        tr = record["trace"]
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    entry = cell_entry(load_json(ROOT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"vlabench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"vlabench: the run loaded {loaded}; the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
                     **out["device"]}
    bad = [k for k, v in out["metrics"].items() if not math.isfinite(v["value"])]
    if bad:
        print(f"vlabench: metrics {bad} are not finite", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
