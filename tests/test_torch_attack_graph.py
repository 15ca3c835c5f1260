"""The attack step's CUDA graph (attacks/graphed.py) on the CPU: which steps
replay one (a CUDA device without a mesh), and, through a stand-in graph
that runs the captured function again at each replay, that the replayed
step equals the eager one, that each replay credits what the capture
counted for the recorder (counters and kept tensors) and
`attack.graph_replays`, and that launch counters count the capture alone.
The eager step's split at the pixels is held to one autograd pass. The
card's own capture is held to the eager step in
tests/test_torch_attack_graph_cuda.py."""

import contextlib
import importlib.util
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from roboticattack_torch.attacks import engine, graphed
from roboticattack_torch.attacks.optimizer import adam_init
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.utils import profiling
from vlabench.common import inputs
from vlabench.common.program import vla_config
from vlabench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INNER, BS, PAD_TO, PATCH, OUTER = 2, 2, 32, 10, 3


class Rerun:
    """A stand-in for graphed.CudaGraph: `capture` runs the function once
    and keeps its outputs; `replay` runs it again with its counts and the
    launch counters in `quiet` set aside (a replay runs no Python) and
    writes the results into those outputs, as a graph's replay overwrites
    its own."""

    made, quiet = [], []

    def __init__(self):
        self.fn, self.outputs, self.captures, self.replays = None, None, 0, 0
        Rerun.made.append(self)

    def capture(self, fn):
        self.tally = profiling._TALLY  # the capture's, whose kept tensors a replay overwrites
        self.fn, self.outputs = fn, fn()
        self.captures += 1
        return self.outputs

    def replay(self):
        counted = [dict(d) for d in Rerun.quiet]
        with profiling.tallying() as tally:
            new = self.fn()
        for d, was in zip(Rerun.quiet, counted):
            d.update(was)
        for a, b in zip(graphed._tensors((self.outputs, self.tally.kept)), graphed._tensors((new, tally.kept))):
            a.copy_(b)
        self.replays += 1


@pytest.fixture
def standin(monkeypatch):
    """Graphs on the CPU, through Rerun."""
    Rerun.made, Rerun.quiet = [], []
    monkeypatch.setattr(graphed, "applies", lambda device, mesh: mesh is None)
    monkeypatch.setattr(graphed, "CudaGraph", Rerun)
    profiling.RECORDER.clear()
    yield Rerun
    profiling.RECORDER.clear()


def _config(family):
    if family == "moonlight":
        from deepseek_tiny import tiny_moonlight

        from vlabench.common import program_moe

        return program_moe.vla_config(tiny_moonlight())
    return vla_config({"mistral": tiny.tiny_mistral, "phi": tiny.tiny_phi}[family]())


def attack(family, objective="uada"):
    """(new_step, params, batch_for, draws_for, patch) of the family's small
    VLA; draws_for(i, bs) and batch_for(bs) are fixed by their arguments."""
    cfg = _config(family)
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    if family == "moonlight":
        from deepseek_tiny import e_bias

        e_bias(params)
    spec = engine.AttackSpec(objective=objective, inner_loop=INNER, optimizer="adamW")
    size = cfg.dino.image_size

    def batch_for(bs=BS):
        return engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, size, bs, PAD_TO))), "cpu")

    def draws_for(i, bs=BS):
        return engine.draw_step(torch.Generator().manual_seed(10 + i), spec, (bs, size, size, 3), (PATCH, PATCH),
                                (bs, PAD_TO))

    def new_step():
        return engine.make_attack_step(spec, cfg, None, range(7))

    return new_step, params, batch_for, draws_for, inputs.initial_patch(3, PATCH)


def run(step, params, batch, draws, patch, outer=OUTER, lr=2e-3, state=None):
    """`outer` outer steps from `state` (a fresh one from `patch` by
    default): (state, [each outer step's metrics])."""
    if state is None:
        state = engine.AttackState(patch=patch.clone(), opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
    seen = []
    for i in range(outer):
        state, metrics = step(params, state, batch, lr * (1 + i), True, draws(i))
        seen.append(metrics)
    return state, seen


def test_a_graph_applies_on_a_cuda_device_without_a_mesh():
    assert graphed.applies(torch.device("cuda"), None) and graphed.applies(torch.device("cuda", 0), None)
    assert not graphed.applies(torch.device("cuda"), object())  # a data- or model-axis mesh
    assert not graphed.applies(torch.device("cpu"), None)


def test_on_the_cpu_the_step_stays_eager(monkeypatch):
    def refuse():
        raise AssertionError("a graph made on the CPU")

    monkeypatch.setattr(graphed, "CudaGraph", refuse)
    new_step, params, batch_for, draws_for, patch = attack("mistral")
    state, seen = run(new_step(), params, batch_for(), draws_for, patch, outer=2)
    assert all(torch.isfinite(m["loss"]).all() for m in seen)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  os.path.join(ROOT, "vlabench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _attack_run(family, launches):
    """OUTER outer steps at BS, the last traced, then 2 at BS + 1: the state
    and metrics after each part, the traced step, the span names under each
    of its inner steps, and the launches counted in each outer step (a
    stand-in counter that each vla_forward adds 1 to)."""
    new_step, params, batch_for, draws_for, patch = attack(family)
    step, state, parts, per_step = new_step(), None, [], []
    for bs, outer in ((BS, OUTER), (BS + 1, 2)):
        batch, seen = batch_for(bs), []
        for i in range(outer):
            before = launches["fwd"]
            traced = bs == BS and i == OUTER - 1
            with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
                state, (metrics,) = run(step, params, batch, lambda _: draws_for(i, bs), patch, outer=1,
                                        lr=2e-3 * (1 + i), state=state)
            seen.append(metrics)
            per_step.append(launches["fwd"] - before)
        parts.append((state, seen))
    (recorded,) = profiling.recorded_steps()
    profiling.RECORDER.clear()
    inner = [j for j, s in enumerate(recorded.spans) if s.name == "attack.inner"]
    phases = [[s.name for s in recorded.spans if s.parent == j] for j in inner]
    return parts, recorded, phases, per_step


@pytest.mark.parametrize("family", ["mistral", "moonlight"])
def test_the_replayed_step_equals_the_eager_step(family, standin, monkeypatch):
    """OUTER outer steps at one batch size (the first eager, the second
    captures and replays, the third replays), then 2 at another (eager,
    then a new capture): patch, AdamW moments and every inner step's
    metrics bit-equal to the eager step's, each inner step's loss its own
    (a stacked view of one output would repeat the last). The traced third
    step counts and keeps what the eager step does (copies of the kept
    tensors, which each replay overwrites). A launch counter counts where
    the Python launches: each eager inner step, the capture once, no
    replay."""
    launches = {"fwd": 0}
    forward = engine.vla_forward

    def counted(*a, **k):
        launches["fwd"] += 1
        return forward(*a, **k)

    monkeypatch.setattr(engine, "vla_forward", counted)
    standin.quiet.append(launches)
    parts, step, phases, per_step = _attack_run(family, launches)
    assert [(g.captures, g.replays) for g in standin.made] == [(1, (OUTER - 1) * INNER), (1, INNER)]
    with monkeypatch.context() as m:
        m.setattr(graphed, "applies", lambda device, mesh: False)
        want, eager, eager_phases, eager_per_step = _attack_run(family, launches)
    assert len(standin.made) == 2
    for (sa, ma), (sb, mb) in zip(parts, want):
        for x, y in ((sa.patch, sb.patch), (sa.opt.m, sb.opt.m), (sa.opt.v, sb.opt.v)):
            assert torch.equal(x, y)
        for x, y in zip(ma, mb):
            assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
            assert len(set(x["loss"].tolist())) == INNER
    assert per_step == [INNER, 1, 0, INNER, 1] and eager_per_step == [INNER] * (OUTER + 2)
    assert phases == [["attack.patch", "attack.graph", "attack.update"]] * INNER
    assert eager_phases == [["attack.patch", "attack.forward", "attack.objective", "attack.backward",
                             "attack.update"]] * INNER
    assert step.counters.pop("attack.graph_replays") == INNER and eager.counters.pop("attack.graph_replays") == 0
    assert step.counters == eager.counters and step.counters["blocks.llm"] > 0
    assert step.kept.keys() == eager.kept.keys() == ({"moe.expert_tokens"} if family == "moonlight" else set())
    for name in step.kept:
        got, expected = step.kept[name], eager.kept[name]
        assert len(got) == len(expected) and all(torch.equal(a, b) for a, b in zip(got, expected))
        assert len({t.data_ptr() for t in got}) == len(got)


def test_the_graph_share_reader(standin, monkeypatch):
    read = _reader("attack.graph_share")
    assert read({}) is None  # an empty recorder
    new_step, params, batch_for, draws_for, patch = attack("phi")
    step, batch = new_step(), batch_for()
    state = None
    for i in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            state, _ = run(step, params, batch, lambda _: draws_for(i), patch, outer=1, state=state)
        assert read({}) == (0.0 if i == 0 else 100.0)
        profiling.RECORDER.clear()
    profiling.RECORDER.steps.append(profiling.OuterStep(id=0, cuda=False))
    assert read({}) is None  # no inner steps
    monkeypatch.setitem(sys.modules, "roboticattack_torch.utils.profiling", None)
    assert read({}) is None  # a program without the recorder


def test_a_tally_takes_counts_and_kept_tensors_and_mutes_spans():
    profiling.RECORDER.clear()
    t = torch.arange(3.0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.outer_step("attack.step", "cpu"):
            with profiling.tallying() as tally:
                assert profiling.span("attention") is profiling._OFF
                profiling.count("blocks.llm", 2)
                profiling.keep("moe.expert_tokens", t)
            profiling.credit(tally)
            t.add_(1.0)  # a replay overwrites the kept tensor: the credited copy holds
            profiling.credit(tally)
    (step,) = profiling.recorded_steps()
    assert [s.name for s in step.spans] == ["attack.step"]
    assert step.counters == {"blocks.llm": 4}
    assert [x.tolist() for x in step.kept["moe.expert_tokens"]] == [[0.0, 1.0, 2.0], [1.0, 2.0, 3.0]]
    profiling.RECORDER.clear()
    with profiling.tallying() as tally:  # without a profiler too
        profiling.count("attention.calls")
    profiling.credit(tally)  # no profiler: nothing recorded
    assert tally.counters == {"attention.calls": 1} and profiling.recorded_steps() == []


def test_the_graph_keeps_the_pixels_gradient_and_copies_the_rest(standin):
    """A replay's loss and metrics are copies the next replay leaves alone."""
    cfg = _config("phi")
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    spec = engine.AttackSpec(objective="uada", inner_loop=1)
    g = graphed.GraphedObjective(lambda p, ids, mask, labels, pixels: engine.pixel_loss_and_grad(
        spec, cfg, p, ids, mask, labels, pixels))
    batch = engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, cfg.dino.image_size, BS, PAD_TO))),
                                   "cpu")
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    assert g.prepare(params, batch.images, batch.input_ids, batch.attention_mask, labels) is None
    replay = g.prepare(params, batch.images, batch.input_ids, batch.attention_mask, labels)
    pixels = [engine.patch_pixels(spec, cfg, batch.images, inputs.initial_patch(s, PATCH), d.inner[0])
              for s, d in ((3, engine.draw_step(torch.Generator().manual_seed(1), spec, batch.images.shape,
                                                (PATCH, PATCH), batch.labels.shape)),
                           (4, engine.draw_step(torch.Generator().manual_seed(2), spec, batch.images.shape,
                                                (PATCH, PATCH), batch.labels.shape)))]
    loss0, metrics0, grad0 = replay(pixels[0])
    kept = loss0.clone(), {k: v.clone() for k, v in metrics0.items()}, grad0.clone()
    loss1, _, grad1 = replay(pixels[1])
    assert torch.equal(loss0, kept[0]) and all(torch.equal(metrics0[k], kept[1][k]) for k in kept[1])
    assert grad1 is grad0 and not torch.equal(loss1, loss0)


@pytest.mark.parametrize("family", ["mistral", "phi", "moonlight"])
def test_the_split_at_the_pixels_equals_one_autograd_pass(family):
    """patch_loss_and_grad (pixel_loss_and_grad on a leaf of the pixels,
    then the paste chain's backward from its gradient) gives the loss and
    patch gradient of one autograd pass from the loss to the patch, bit for
    bit."""
    _, params, batch_for, draws_for, patch = attack(family)
    cfg = _config(family)
    spec = engine.AttackSpec(objective="uada", inner_loop=INNER, optimizer="adamW")
    batch, d = batch_for(), draws_for(0).inner[0]
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    loss, metrics, grad = engine.patch_loss_and_grad(spec, cfg, params, patch, batch, labels, d)
    leaf = patch.clone().requires_grad_(True)
    with torch.enable_grad():
        pixels = engine.patch_pixels(spec, cfg, batch.images, leaf, d)
        want_loss, want_metrics = engine._objective(spec, cfg, params, batch.input_ids, batch.attention_mask,
                                                    labels, pixels)
        (want,) = torch.autograd.grad(want_loss, leaf)
    assert torch.equal(loss, want_loss.detach()) and torch.equal(grad, want) and grad.abs().sum() > 0
    assert all(torch.equal(metrics[k], want_metrics[k].detach()) for k in want_metrics)
