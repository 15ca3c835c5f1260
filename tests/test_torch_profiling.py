"""`utils/profiling.maybe_trace` on torch.profiler (the JAX package's
jax.profiler context) and the attack CLI's `--profile`: on the CPU a
readable Chrome trace of host activity and the program's spans, one file
per rank, written only when a directory is given."""

import json
import os

import pytest
import torch

from roboticattack_torch.cli import attack as cli
from roboticattack_torch.utils.profiling import maybe_trace


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_maybe_trace_writes_a_chrome_trace_only_with_a_directory(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    x = torch.randn(16, 16)
    with maybe_trace(None):
        x @ x
    with maybe_trace(""):
        x @ x
    assert os.listdir(tmp_path) == []
    with maybe_trace(str(tmp_path / "trace")):
        x @ x
    assert os.listdir(tmp_path / "trace") == ["trace_rank0.json"]
    names = {e.get("name") for e in _events(tmp_path / "trace" / "trace_rank0.json")}
    assert "aten::matmul" in names or "aten::mm" in names
    assert f"trace written to {tmp_path / 'trace' / 'trace_rank0.json'}" in capsys.readouterr().out


def test_profile_flag_traces_step_one_of_a_cli_run(tmp_path):
    out = tmp_path / "run"
    cli.main(["--attack", "tma", "--model", "vla-tiny", "--device", "cpu", "--dataset", "dummy",
              "--maskidx", "6", "--iter", "2", "--innerLoop", "1", "--bs", "2", "--eval_every", "2",
              "--eval_batches", "1", "--output", str(out), "--profile", str(tmp_path / "trace")])
    assert os.listdir(tmp_path / "trace") == ["trace_rank0.json"]
    events = _events(tmp_path / "trace" / "trace_rank0.json")
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the program's spans, each inside one of the last: the step's layers on the trace
    spans = [e for e in events if e.get("ph") == "X"]
    outer = [e for e in spans if e["name"] == "attack.step"]
    assert len(outer) == 1
    for name in ("attack.inner", "attack.forward", "vla.llm", "attention"):
        outer = [e for e in spans if e["name"] == name and any(_inside(e, o) for o in outer)]
        assert outer, name
    assert (out / "final" / "patch.pt").is_file()


def _inside(e, o):
    return o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]


class _Event:
    """A profiler event as the trace reduction reads it (times in us)."""

    def __init__(self, name, device, start, end, annotation=False):
        self.name, self.device_type, self.is_user_annotation = name, device, annotation
        self.time_range = torch.autograd.profiler_util.Interval(start, end)


def test_chip_smoke_device_profile_counts_device_work_alone(monkeypatch):
    import chip_smoke

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_Event("attack.step", cpu, 0, 100), _Event("attack.step", cuda, 0, 100, annotation=True),
              _Event("gemm_a", cuda, 10, 30), _Event("gemm_a", cuda, 20, 40), _Event("copy", cuda, 60, 70),
              _Event("Command Buffer Full", cuda, 80, 90)]

    class Profile:
        def __init__(self, found):
            self.found = found

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.found

    # a span's shadow on the device timeline and a runtime marker are not device work
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: Profile(events))
    got = chip_smoke.device_profile(lambda: None, 1.0, "t", "card", match=("gemm",))
    assert got == {"gemm": pytest.approx(0.04), "busy": pytest.approx(0.04)}
    monkeypatch.setattr(torch.profiler, "profile", lambda **k: Profile(events[:1]))
    got = chip_smoke.device_profile(lambda: None, 1.0, "t", "card", match=("gemm",))
    assert got == {"gemm": "not measured", "busy": "not measured"}
