"""The trace reduction and the per-layer readers on records made by hand
(CPU), and the reduction of a real profile on the card."""

import pytest
import torch

from vlabench import run
from vlabench.common.trace import DeviceTrace, TraceSummary, name_gaps, union


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_gaps_are_named_by_the_innermost_host_event():
    busy = [(10.0, 20.0), (30.0, 40.0)]
    host = sorted([(0.0, 100.0, "vlabench.step"), (22.0, 28.0, "aten::item"), (41.0, 49.0, "vlabench.sync")])
    gaps = name_gaps(busy, host, 0.0, 50.0)
    assert sorted(gaps) == sorted([("vlabench.step", 10e-6), ("aten::item", 10e-6), ("vlabench.sync", 10e-6)])


def record(**kw):
    tr = TraceSummary(window_s=2.0, busy_s=1.5, by_name={"nvjet_tst_128x": (10, 0.9), "elementwise_kernel": (5, 0.3),
                                                         "sm90_xmma_gemm_bf16": (2, 0.15)},
                      gaps=[("vlabench.sync", 0.3), ("aten::copy_", 0.2)])
    rec = {"trace": tr, "outer_s": [4.0, 5.0, 6.0], "inner_loop": 5, "inner_steps": 20, "window_s": 20.0,
           "flops_per_inner_step": 72e12, "peak_flops": 989e12}
    rec.update(kw)
    return rec


def test_attack_readers():
    rec = record()
    read = {n: run.load_module("metrics", n).read(rec) for n in
            ("attack.inner_step_ms_p50", "attack.matmul_share", "device_idle_share.attack", "mfu.attack",
             "attack.device_ms_per_inner_step")}
    assert read["attack.inner_step_ms_p50"] == pytest.approx(1000.0)
    assert read["attack.matmul_share"] == pytest.approx(70.0)
    assert read["device_idle_share.attack"] == pytest.approx(25.0)
    assert read["mfu.attack"] == pytest.approx(100 * 20 * 72e12 / 20.0 / 989e12)
    assert read["attack.device_ms_per_inner_step"] == pytest.approx(300.0)


def test_readers_with_nothing_to_read_return_nothing():
    rec = record(trace=None, outer_s=[], inner_steps=0)
    for n in ("attack.inner_step_ms_p50", "attack.matmul_share", "device_idle_share.attack", "mfu.attack",
              "attack.device_ms_per_inner_step"):
        assert run.load_module("metrics", n).read(rec) is None


def test_breakdown_lists_ops_and_gaps():
    b = record()["trace"].breakdown()
    assert b["device_ops"][0] == ["nvjet_tst_128x", 0.9] and len(b["device_ops"]) == 3
    assert b["idle_gaps"] == [["vlabench.sync", 0.3], ["aten::copy_", 0.2]]


@pytest.mark.cuda
def test_device_trace_of_products_on_the_card(cuda):
    a = torch.randn(4096, 4096, device=cuda, dtype=torch.bfloat16)
    with DeviceTrace(host=False) as tr:
        for _ in range(20):
            a = (a @ a).clamp(-1, 1)
    s = tr.reduce()
    assert 0 < s.busy_s <= s.window_s and s.seconds_matching(("gemm", "nvjet", "xmma")) > 0
