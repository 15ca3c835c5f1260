"""`utils/profiling.maybe_trace` on torch.profiler (the JAX package's
jax.profiler context) and the attack CLI's `--profile`: on the CPU a
readable Chrome trace of host activity, one file per rank, written only
when a directory is given."""

import json
import os

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
    names = {e.get("name", "") for e in _events(tmp_path / "trace" / "trace_rank0.json")}
    assert any(n.startswith("aten::") for n in names)
    assert (out / "final" / "patch.pt").is_file()
