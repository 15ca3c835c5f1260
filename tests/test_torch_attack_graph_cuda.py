"""The attack step's CUDA graph (attacks/graphed.py) against the eager step,
on the card: a Mistral VLA at the benchmark cell's widths cut to 2 blocks a
tower and 2 decoder layers, and the small Moonlight-shaped VLA of
tests/deepseek_tiny.py, both in bf16; 3 outer steps of 5 inner steps, the
first eager, the second captured and replayed, the third replayed; then a
second batch shape, which captures anew.

Every test here carries the `cuda` marker and skips where no card is
present. The file imports neither jax nor the JAX package (the
repository's conftest does, hence `--noconftest`):

    python -m pytest tests/test_torch_attack_graph_cuda.py -m cuda --noconftest -q
"""

import collections
import copy
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from roboticattack_torch.attacks import engine, graphed
from roboticattack_torch.attacks.optimizer import adam_init
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.ops import flash_attention as fa
from roboticattack_torch.utils import profiling
from roboticattack_torch.utils.labels import build_tma_target_tokens
from vlabench.common import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INNER, OUTER, PATCH, PAD_TO = 5, 3, 50, 32


class Counted(graphed.CudaGraph):
    """The program's graph, counting its replays and the sync debug mode
    its captured function ran under."""

    made, modes = [], []

    def __init__(self):
        super().__init__()
        self.replays = 0
        Counted.made.append(self)

    def capture(self, fn):
        def checked():
            Counted.modes.append(torch.cuda.get_sync_debug_mode())
            return fn()

        return super().capture(checked)

    def replay(self):
        super().replay()
        self.replays += 1


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    Counted.made, Counted.modes = [], []
    monkeypatch.setattr(graphed, "CudaGraph", Counted)
    profiling.RECORDER.clear()
    yield torch.device("cuda")
    profiling.RECORDER.clear()


def _mistral_cut():
    from vlabench.common.program import vla_config

    with open(os.path.join(ROOT, "vlabench", "configs", "vla-mistral-7b.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["llm"]["num_hidden_layers"] = 2
    for t in cfg["vision"]["towers"]:
        t["depth"] = 3  # the towers tap the second-to-last block: 2 run
    return vla_config(cfg)


def _moonlight_tiny():
    from deepseek_tiny import tiny_moonlight

    from vlabench.common import program_moe

    return program_moe.vla_config(tiny_moonlight("bfloat16"))


CONFIGS = {"mistral_cut": _mistral_cut, "moonlight_tiny": _moonlight_tiny}


def setup(name, device, objective="uada", seed=0):
    cfg = CONFIGS[name]()
    params = init_vla_params(torch.Generator(device=device).manual_seed(seed), cfg)
    if name == "moonlight_tiny":
        from deepseek_tiny import e_bias

        e_bias(params)
        params["llm"]["moe"]["e_bias"] = params["llm"]["moe"]["e_bias"].to(device)
    spec = engine.AttackSpec(objective=objective, inner_loop=INNER, optimizer="adamW")
    size = cfg.dino.image_size

    def batch_for(bs):
        return engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(seed + 3, size, bs, PAD_TO))), device)

    def draws_for(i, bs):
        return engine.draw_step(torch.Generator().manual_seed(100 + i), spec, (bs, size, size, 3), (PATCH, PATCH),
                                (bs, PAD_TO))

    return cfg, params, spec, batch_for, draws_for


def new_step(spec, cfg):
    """The attack step of `spec`: TMA on the gripper dimension towards 0,
    the other objectives on all 7 dimensions."""
    if spec.objective == "tma":
        return engine.make_attack_step(spec, cfg, build_tma_target_tokens(np.zeros(7), [6]), [6])
    return engine.make_attack_step(spec, cfg, None, range(7))


def outer_steps(step, params, batch, draws, state, first, n):
    """n outer steps from outer step `first`: (state, [metrics])."""
    seen = []
    for i in range(first, first + n):
        state, metrics = step(params, state, batch, 2e-3 * (1 + i), True, draws(i))
        seen.append(metrics)
    torch.cuda.synchronize()
    return state, seen


def attack_run(name, device, spec_cfg, graphs: bool):
    """OUTER outer steps at bs 8, then 2 at bs 4, from one initial patch:
    [(state, metrics)] after each part."""
    cfg, params, spec, batch_for, draws_for = spec_cfg
    saved = graphed.applies
    graphed.applies = saved if graphs else (lambda device, mesh: False)
    try:
        step = new_step(spec, cfg)
        patch = inputs.initial_patch(5, PATCH).to(device)
        state = engine.AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
        state, first = outer_steps(step, params, batch_for(8), lambda i: draws_for(i, 8), state, 0, OUTER)
        part1 = (state, first)
        state, second = outer_steps(step, params, batch_for(4), lambda i: draws_for(i, 4), state, OUTER, 2)
        return [part1, (state, second)]
    finally:
        graphed.applies = saved


def compare(got, want, label):
    """Bit-equal, or within 1e-6 relative where cuBLAS took another
    algorithm under capture; returns whether every tensor was bit-equal."""
    exact = True
    for (sg, mg), (sw, mw) in zip(got, want):
        pairs = [("patch", sg.patch, sw.patch), ("m", sg.opt.m, sw.opt.m), ("v", sg.opt.v, sw.opt.v)]
        pairs += [(f"{k}[{i}]", a[k], b[k]) for i, (a, b) in enumerate(zip(mg, mw)) for k in b]
        for what, a, b in pairs:
            exact &= torch.equal(a, b)
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=lambda m: f"{label} {what}: {m}")
    print(f"{label}: graphed against eager, bit-equal: {exact}")
    return exact


@pytest.mark.cuda
@pytest.mark.parametrize("name,objective", [("mistral_cut", "uada"), ("moonlight_tiny", "uada"),
                                            ("mistral_cut", "tma"), ("mistral_cut", "upa")])
def test_the_graphed_step_equals_the_eager_step(cuda, name, objective):
    """3 outer steps of 5 inner steps, then 2 at another batch size: the
    losses and metrics of every inner step, the patch and AdamW's moments
    as the eager step's. The bs 8 graph is captured once and replayed at 10
    inner steps, the bs 4 one captured at the second call of its shape; each
    capture ran with synchronizing calls raising; the stacked losses of an
    outer step are 5 values, not one repeated."""
    s = setup(name, cuda, objective)
    graph = attack_run(name, cuda, s, graphs=True)
    assert [g.replays for g in Counted.made] == [(OUTER - 1) * INNER, INNER]
    assert Counted.modes == [2, 2]  # "error"
    eager = attack_run(name, cuda, s, graphs=False)
    assert len(Counted.made) == 2
    compare(graph, eager, f"{name} {objective}")
    for _, metrics in graph:
        for m in metrics:
            assert len(set(m["loss"].tolist())) > 1


@pytest.mark.cuda
def test_a_graphed_step_is_traced_and_counted_as_the_eager_one(cuda):
    """Under the profiler, the outer step that captures and the one that
    only replays each run on the device the kernels the eager step runs,
    by name and number (B1 and B2 among them), and record what the eager
    step records: blocks, attention calls and B1 launches, and 5 replays.
    The kernels' launch counters count the host's launches: one inner
    step's at the capture, none at a replay."""
    cfg, params, spec, batch_for, draws_for = setup("mistral_cut", cuda)
    batch = batch_for(8)
    seen = {}
    for graphs in (True, False):
        saved = graphed.applies
        graphed.applies = saved if graphs else (lambda device, mesh: False)
        try:
            step = new_step(spec, cfg)
            patch = inputs.initial_patch(5, PATCH).to(cuda)
            state = engine.AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
            state, _ = outer_steps(step, params, batch, lambda i: draws_for(i, 8), state, 0, 1)
            for i in (1, 2):  # the capture's call, then a replay's
                fa.reset_launches()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, _ = outer_steps(step, params, batch, lambda i: draws_for(i, 8), state, i, 1)
                (recorded,) = profiling.recorded_steps()
                profiling.RECORDER.clear()
                kernels = collections.Counter(e.name for e in prof.events()
                                              if e.device_type == torch.autograd.DeviceType.CUDA)
                seen[graphs, i] = recorded.counters, dict(fa.flash_attention.launches), kernels
        finally:
            graphed.applies = saved
    for i in (1, 2):
        (counters, launches, kernels), (eager_counters, eager_launches, eager_kernels) = seen[True, i], seen[False, i]
        assert counters.pop("attack.graph_replays") == INNER and eager_counters.pop("attack.graph_replays") == 0
        assert counters == eager_counters and counters["attention.kernel"] == counters["attention.calls"] > 0
        assert eager_launches["fwd"] == counters["attention.kernel"]
        assert launches == ({k: v // INNER for k, v in eager_launches.items()} if i == 1 else {"fwd": 0, "bwd": 0})
        flash = {k: n for k, n in kernels.items() if "flash_" in k}
        assert flash == {k: n for k, n in eager_kernels.items() if "flash_" in k}, (flash, eager_kernels)
        assert sum(n for k, n in flash.items() if "flash_fwd_kernel" in k) == eager_launches["fwd"] > 0
