"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.fullmatch(p) for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)


def test_names_units_and_lines():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads") for x in b[k]]
    metrics = [m["name"] for k in ("end_to_end", "per_layer") for m in b[k]]
    for n in names + metrics + [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]:
        assert NAME.fullmatch(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])


def test_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        assert sum(w in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(w in m.get("workloads", ()) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and line(m["layer"])
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_file():
    b = bench()
    for c in b["configs"]:
        cfg = load("configs", c["name"])
        assert c["file"] == f"vlabench/configs/{c['name']}.json" and cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"], w["why"])
        assert os.path.isfile(os.path.join(HERE, "drivers", cell["driver"] + ".py"))
        assert load("traffic", w["traffic"])["name"] == w["traffic"]
        assert all(0 < v < 1 for v in cell["limits"].values())
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic", "metrics", "drivers"])
def test_file_names_are_names(kind):
    for f in os.listdir(os.path.join(HERE, kind)):
        if f != "__pycache__":
            assert NAME.fullmatch(f.rsplit(".", 1)[0]), f
