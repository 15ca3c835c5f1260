"""The attack path's spans and counters (`utils/profiling.span`,
`outer_step`, `count`) on the benchmark's small configurations of both
families, on the CPU: off without a profiler (nothing built, nothing kept,
the step bit-equal to one with the recorder stubbed out), nested and
counted as the step's structure under one, on the profiler's clock, and
read by the benchmark's per-layer readers."""

import dataclasses
import functools
import importlib.util
import os
import statistics
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from roboticattack_torch.attacks import engine
from roboticattack_torch.attacks.optimizer import adam_init
from roboticattack_torch.models import llama, phi, vit, vlm
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.ops import attention
from roboticattack_torch.utils import profiling
from vlabench.common import inputs
from vlabench.common.program import vla_config
from vlabench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"mistral": tiny.tiny_mistral, "phi": tiny.tiny_phi}
INNER, BS, PAD_TO, PATCH = 2, 2, 32, 10
READERS = ("attack.forward_host_ms", "attack.backward_host_ms", "attack.forward_stream_ms",
           "attack.backward_stream_ms", "attack.attention_stream_ms", "attack.blocks_run_per_inner_step")
PHASES = ["attack.patch", "attack.forward", "attack.objective", "attack.backward", "attack.update"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()


def attack(family, remat=True, attn_impl="chunked"):
    """(run, cfg): run() takes one UADA outer step of INNER inner steps of
    the family's small VLA from fixed weights, batch, draws and patch, and
    returns (patch, m, v, losses)."""
    cfg = vla_config(FAMILIES[family]())
    cfg = dataclasses.replace(cfg, remat=remat, llm=dataclasses.replace(cfg.llm, attn_impl=attn_impl))
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    spec = engine.AttackSpec(objective="uada", inner_loop=INNER, optimizer="adamW")
    step = engine.make_attack_step(spec, cfg, None, range(7))
    size = cfg.dino.image_size
    batch = engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, size, BS, PAD_TO))), "cpu")
    draws = engine.draw_step(torch.Generator().manual_seed(1), spec, (BS, size, size, 3), (PATCH, PATCH),
                             (BS, PAD_TO))
    patch = inputs.initial_patch(3, PATCH)

    def run():
        state = engine.AttackState(patch=patch.clone(), opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
        state, metrics = step(params, state, batch, 2e-3, True, draws)
        return state.patch, state.opt.m, state.opt.v, metrics["loss"]

    return run, cfg


def traced(family, **kw):
    run, cfg = attack(family, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    (step,) = profiling.recorded_steps()
    return step, cfg, prof


@functools.lru_cache(maxsize=None)
def traced_step(family, remat, attn_impl):
    """traced()'s step and config, made once a process for each argument."""
    profiling.RECORDER.clear()
    step, cfg, _ = traced(family, remat=remat, attn_impl=attn_impl)
    return step, cfg


def tower_blocks(cfg):
    return cfg.dino.tap_layer + (cfg.siglip.tap_layer if cfg.siglip is not None else 0)


@pytest.mark.parametrize("family", FAMILIES)
def test_without_a_profiler_the_step_is_untouched(family, monkeypatch):
    run, _ = attack(family)
    assert profiling.span("a") is profiling.span("b") is profiling.outer_step("c", "cpu")

    def refuse(*a, **k):
        raise AssertionError("built while no profiler records")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        present = run()
    assert profiling.recorded_steps() == []

    def off(*a, **k):
        return profiling._OFF

    for mod in (engine, vlm, vit, llama, phi, attention):
        for name in ("span", "outer_step", "count"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, off)
    stubbed = run()
    for a, b in zip(present, stubbed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("attn_impl", ["chunked", "xla"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("family", FAMILIES)
def test_spans_nest_and_counters_follow_the_structure(family, remat, attn_impl):
    """The structure below under either plain attn_impl, and the same spans
    and counters under both ("chunked" means "xla" in the port)."""
    step, cfg = traced_step(family, remat, attn_impl)
    other, _ = traced_step(family, remat, "xla" if attn_impl == "chunked" else "chunked")
    assert ([(s.name, s.parent, s.recompute) for s in step.spans]
            == [(s.name, s.parent, s.recompute) for s in other.spans])
    assert step.counters == other.counters
    spans = step.spans
    children = {i: [j for j, s in enumerate(spans) if s.parent == i] for i in range(len(spans))}

    def names(i):
        return [spans[j].name for j in children[i]]

    assert spans[0].name == "attack.step" and spans[0].parent is None
    assert names(0) == ["attack.inner"] * INNER
    towers, layers = tower_blocks(cfg), cfg.llm.num_layers
    for inner in children[0]:
        assert names(inner) == PHASES
        fwd, bwd = children[inner][1], children[inner][3]
        assert names(fwd) == ["vla.vision", "vla.llm"]
        vision, llm = children[fwd]
        assert names(vision) == ["attention"] * towers and names(llm) == ["attention"] * layers
        under = [j for j in range(len(spans)) if _within(spans, j, bwd)]
        assert all(spans[j].recompute for j in under)
        assert not any(spans[j].recompute for j in range(len(spans)) if _within(spans, j, inner) and j not in under)
        # remat: the vision encode once more, then each block's own recompute
        assert sorted(spans[j].name for j in under) == (
            sorted(["vla.vision"] + ["attention"] * (2 * towers + layers)) if remat else [])

    runs = (3, 2) if remat else (1, 1)
    c = {k: v / INNER for k, v in step.counters.items()}
    assert c["blocks.vision"] == runs[0] * towers and c["blocks.llm"] == runs[1] * layers
    assert c["attention.calls"] == c["blocks.vision"] + c["blocks.llm"] == len(step.named("attention")) / INNER


def _within(spans, j, ancestor):
    p = spans[j].parent
    while p is not None:
        if p == ancestor:
            return True
        p = spans[p].parent
    return False


@pytest.mark.parametrize("family", FAMILIES)
def test_span_stamps_share_the_profilers_clock(family):
    """Each in-memory span lies inside the profiler's event of the same span
    to 1 ms (its stamps are taken just inside the record_function, so a
    clock offset over 1 ms either way fails), and the median edge lies
    within 1 ms of it. A pause between the two stamps (the collector, or the
    OS on a loaded machine) only moves the in-memory span inward."""
    step, _, prof = traced(family)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    ms, gaps = 1_000_000, []
    for name in {s.name for s in step.spans}:
        theirs = events[name]
        assert len(step.named(name)) == len(theirs), name
        for s in step.named(name):
            assert any(c - ms <= s.start_ns <= s.end_ns <= d + ms for c, d in theirs), name
            gaps.append(min(max(abs(s.start_ns - c), abs(s.end_ns - d)) for c, d in theirs))
    assert statistics.median(gaps) < ms


def test_spans_on_another_thread_sit_under_the_open_backward_span():
    rec = profiling.Recorder()
    step = rec.open("attack.step", False, "cpu")
    back = rec.open("attack.backward", True)
    seen = []
    worker = threading.Thread(target=lambda: seen.append(rec.open("attention", False)))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    (token,) = seen
    rec.close(token)
    rec.close(back)
    after = rec.open("attack.update", False)
    rec.close(after)
    rec.close(step)
    (s,) = rec.steps
    got = [(x.name, x.parent, x.recompute) for x in s.spans]
    assert got == [("attack.step", None, False), ("attack.backward", 0, False), ("attention", 1, True),
                   ("attack.update", 0, False)]
    assert s.spans[2].thread != s.spans[1].thread and all(x.end_ns >= x.start_ns for x in s.spans)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  os.path.join(ROOT, "vlabench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Event:
    """A stand-in for a CUDA event at host time `t` (ms)."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_first_recorded_step(name, monkeypatch):
    read = _reader(name)
    assert read({}) is None  # an empty recorder
    step, _, _ = traced("mistral")
    for s in step.spans:  # stream times as if on CUDA: 2x each span's host time
        s.events = (_Event(0.0), _Event(2 * s.host_ms()))
    later = profiling.OuterStep(id=step.id + 1, cuda=False)
    profiling.RECORDER.steps.append(later)  # a later step is not read
    want = {
        "attack.forward_host_ms": step.host_ms("attack.forward") / INNER,
        "attack.backward_host_ms": step.host_ms("attack.backward") / INNER,
        "attack.forward_stream_ms": 2 * step.host_ms("attack.forward") / INNER,
        "attack.backward_stream_ms": 2 * step.host_ms("attack.backward") / INNER,
        "attack.attention_stream_ms": 2 * step.host_ms("attention") / INNER,
        "attack.blocks_run_per_inner_step": (step.counters["blocks.vision"] + step.counters["blocks.llm"]) / INNER,
    }[name]
    assert read({}) == pytest.approx(want) and want > 0
    monkeypatch.setitem(sys.modules, "roboticattack_torch.utils.profiling", None)
    assert read({}) is None  # a program without the recorder


def test_the_kernel_share_reader_reads_the_first_recorded_steps_counters(monkeypatch):
    """attack.attention_kernel_share: `attention.kernel` over
    `attention.calls` of the first recorded step, in %. The CPU's plain
    attention keeps the counter at 0; a program that keeps no such counter
    (or no recorder) reads None."""
    read = _reader("attack.attention_kernel_share")
    assert read({}) is None  # an empty recorder
    step, _, _ = traced("phi")
    calls = step.counters["attention.calls"]
    assert step.counters["attention.kernel"] == 0 and calls > 0 and read({}) == 0.0
    profiling.RECORDER.steps.append(profiling.OuterStep(id=step.id + 1, cuda=False))  # a later step is not read
    step.counters["attention.kernel"] = calls
    assert read({}) == pytest.approx(100.0)
    step.counters["attention.kernel"] = calls // 4
    assert read({}) == pytest.approx(100.0 * (calls // 4) / calls)
    del step.counters["attention.kernel"]
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "roboticattack_torch.utils.profiling", None)
    assert read({}) is None


@pytest.mark.parametrize("family", [*FAMILIES, "moonlight"])
def test_the_norm_share_reader_reads_the_first_recorded_steps_counters(family, monkeypatch):
    """attack.norm_kernel_share: `norm.kernel` over `norm.calls` of the
    first recorded step, in %. Under per-block recomputation an inner step
    runs each tower block's 2 norms three times, CLIP's pre-norm twice (the
    forward and the vision encode's recomputation), each decoder block's
    norms (2 Llama, 1 Phi, 3 DeepSeek-V3) twice and the final norm once.
    The CPU's plain norms keep the kernel counter at 0; a program that keeps
    no such counter (or no recorder) reads None."""
    read = _reader("attack.norm_kernel_share")
    assert read({}) is None  # an empty recorder
    step, cfg = (traced(family) if family in FAMILIES else traced_moonlight())[:2]
    per_block = {"LlamaConfig": 2, "PhiConfig": 1, "DeepseekV3Config": 3}[type(cfg.llm).__name__]
    pre = sum(t.pre_norm for t in (cfg.dino, cfg.siglip) if t is not None)
    calls = step.counters["norm.calls"]
    assert calls == INNER * (6 * tower_blocks(cfg) + 2 * pre + 2 * per_block * cfg.llm.num_layers + 1)
    assert step.counters["norm.kernel"] == 0 and read({}) == 0.0
    profiling.RECORDER.steps.append(profiling.OuterStep(id=step.id + 1, cuda=False))  # a later step is not read
    step.counters["norm.kernel"] = calls
    assert read({}) == pytest.approx(100.0)
    step.counters["norm.kernel"] = calls // 3
    assert read({}) == pytest.approx(100.0 * (calls // 3) / calls)
    del step.counters["norm.kernel"]
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "roboticattack_torch.utils.profiling", None)
    assert read({}) is None


def traced_moonlight(remat=True):
    """One traced UADA outer step of the tiny Moonlight-shaped VLA
    (tests/deepseek_tiny.py) with a nonzero correction bias."""
    from deepseek_tiny import e_bias, tiny_moonlight

    from vlabench.common import program_moe

    cfg = dataclasses.replace(program_moe.vla_config(tiny_moonlight()), remat=remat)
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    e_bias(params)
    spec = engine.AttackSpec(objective="uada", inner_loop=INNER, optimizer="adamW")
    step = engine.make_attack_step(spec, cfg, None, range(7))
    size = cfg.dino.image_size
    batch = engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, size, BS, PAD_TO))), "cpu")
    draws = engine.draw_step(torch.Generator().manual_seed(1), spec, (BS, size, size, 3), (PATCH, PATCH),
                             (BS, PAD_TO))
    patch = inputs.initial_patch(3, PATCH)
    state = engine.AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, state, batch, 2e-3, True, draws)
    (recorded,) = profiling.recorded_steps()
    return recorded, cfg, params, batch


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_moe_spans_nest_under_the_decoder_and_the_backward(remat):
    """A `moe` span a sparse-expert layer call: under `vla.llm` in the
    forward, flagged `recompute` under `attack.backward` with remat;
    `blocks.llm` counts every layer once a pass."""
    step, cfg, _, _ = traced_moonlight(remat)
    spans = step.spans
    sparse = cfg.llm.num_moe_layers
    towers = tower_blocks(cfg)
    inners = [j for j, s in enumerate(spans) if s.name == "attack.inner"]
    assert len(inners) == INNER
    for inner in inners:
        fwd = next(j for j, s in enumerate(spans) if s.name == "attack.forward" and s.parent == inner)
        bwd = next(j for j, s in enumerate(spans) if s.name == "attack.backward" and s.parent == inner)
        (llm,) = [j for j, s in enumerate(spans) if s.name == "vla.llm" and s.parent == fwd]
        assert [s.name for s in spans if s.parent == llm] == ["attention"] + ["attention", "moe"] * sparse
        under = [spans[j] for j in range(len(spans)) if _within(spans, j, bwd)]
        assert all(s.recompute for s in under)
        assert sum(s.name == "moe" for s in under) == (sparse if remat else 0)
        assert not any(s.recompute for j, s in enumerate(spans) if s.name == "moe" and _within(spans, j, fwd))
    runs = 2 if remat else 1
    assert step.counters["blocks.llm"] == INNER * runs * cfg.llm.num_layers
    assert step.counters["blocks.vision"] == INNER * (3 if remat else 1) * towers
    assert step.counters["attention.calls"] == step.counters["blocks.llm"] + step.counters["blocks.vision"]


def test_the_expert_load_reader_equals_a_hand_count(monkeypatch):
    """attack.expert_load_max_over_mean: each sparse layer call's routed
    rows by expert, kept on the device for the step, equal a count of the
    expert choices made by hand from the layer's input; the reader gives
    the mean over the calls of max over mean."""
    from roboticattack_torch.models import deepseek

    seen = []
    original = deepseek.moe

    def spy(cfg, y, p, routes, li):
        seen.append((li, y.detach().clone(), p))
        return original(cfg, y, p, routes, li)

    monkeypatch.setattr(deepseek, "moe", spy)
    step, cfg, _, _ = traced_moonlight(remat=True)
    kept = step.kept["moe.expert_tokens"]
    assert len(kept) == len(seen) == INNER * 2 * cfg.llm.num_moe_layers  # forward and recomputation
    ratios = []
    for rows, (li, y, p) in zip(kept, seen):
        flat = y.reshape(-1, y.shape[-1])
        idx = deepseek.choose_experts(cfg.llm, deepseek.router_scores(flat, p["router_w"]), p["e_bias"])
        hand = torch.stack([(idx == e).sum() for e in range(cfg.llm.n_routed_experts)]).int()
        assert rows.dtype == torch.int32 and torch.equal(rows, hand)
        assert int(rows.sum()) == flat.shape[0] * cfg.llm.num_experts_per_tok
        ratios.append(float(hand.max()) / float(hand.float().mean()))
    read = _reader("attack.expert_load_max_over_mean")
    assert read({}) == pytest.approx(sum(ratios) / len(ratios)) and read({}) > 1.0


def test_the_moe_stream_reader_reads_the_moe_spans(monkeypatch):
    read = _reader("attack.moe_stream_ms")
    assert read({}) is None  # an empty recorder
    step, _, _, _ = traced_moonlight()
    for s in step.spans:
        s.events = (_Event(0.0), _Event(2 * s.host_ms()))
    assert read({}) == pytest.approx(2 * step.host_ms("moe") / INNER) and read({}) > 0
    for s in step.spans:  # a step that recorded no CUDA events
        s.events = None
    assert read({}) is None
    monkeypatch.setitem(sys.modules, "roboticattack_torch.utils.profiling", None)
    assert read({}) is None


def test_the_moe_readers_read_nothing_in_the_dense_cells():
    """A dense family's step has no `moe` span and keeps no expert rows: the
    two readers give None (their cells list the sparse cell alone)."""
    traced("mistral")
    assert _reader("attack.moe_stream_ms")({}) is None
    assert _reader("attack.expert_load_max_over_mean")({}) is None


def test_the_roofline_reader_reads_the_grouped_kernels():
    """attack.moe_roofline_share: the bound of the traced step's inner steps
    over the device time of the kernels named as PyTorch's sm90 grouped
    GEMM; None without them or without the bound."""
    from vlabench.common.trace import TraceSummary

    read = _reader("attack.moe_roofline_share")
    grouped = "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeE"
    prepare = "void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t>"
    tr = TraceSummary(window_s=3.0, busy_s=2.0, by_name={grouped: (1170, 0.2), prepare: (1170, 0.005),
                                                          "nvjet_tst_192x192": (10, 0.5)})
    rec = {"trace": tr, "moe_bound_s": 0.0325, "inner_loop": 5}
    assert read(rec) == pytest.approx(100.0 * 0.0325 * 5 / 0.205)
    assert read(dict(rec, trace=TraceSummary(3.0, 2.0, {"nvjet_tst_192x192": (10, 0.5)}))) is None
    assert read({k: v for k, v in rec.items() if k != "moe_bound_s"}) is None
    assert read({}) is None
