"""The port's VLA trainer (roboticattack_torch/training/) against the JAX
package's, in one process on VLA_TINY.

- `VLATrainer` against JAX's `VLATrainer` on the same weights
  (models/bridge.params_from_jax) and the same numpy batches, with
  attn_impl="flash" on both sides (JAX interprets its Pallas kernels, the
  port runs their plain versions): warmup with weight decay (no clipping),
  a max_grad_norm that clips, grad_accumulation_steps=2, the vision towers
  frozen, the LLM frozen. Each of 6 steps' loss and every leaf after them;
  the first step (lr 0) leaves every leaf bit-equal.
- JAX's test_training.py cases on the port: the loss falls under ddp and
  fsdp, the freeze masks (equal to JAX's), frozen leaves that do not move,
  the checkpoint round trip with its names and the `latest-checkpoint`
  link.
- `fsdp_shardings` gives JAX's PartitionSpecs on OpenVLA-7B's shapes (meta
  tensors here, ShapeDtypeStructs there: nothing is allocated) for 2, 4
  and 8 ranks; `VLAMetrics` pushes what JAX's pushes but for the wall-clock
  `step_time`; `Overwatch` logs and runs rank-0-only code on rank 0 only.

Tolerances: losses rtol 1e-4 (measured ~2e-7); every parameter element
within 1e-4 absolute, lr x steps / 300 at lr 5e-3 over 6 steps (measured
<= 7e-6: the forward and backward in f32 in two frameworks, through Adam)."""

import dataclasses
import json
import logging
import os

import numpy as np
import jax
import pytest
import torch

from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import OPENVLA_7B as J_7B
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.training import TrainConfig as JTrainConfig
from roboticattack_tpu.training import VLATrainer as JVLATrainer
from roboticattack_tpu.training import fsdp_shardings as jfsdp_shardings
from roboticattack_tpu.training import trainable_mask as jtrainable_mask
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.param_tree import tree_from_leaves, tree_leaves
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.parallel import distributed
from roboticattack_torch.parallel.mesh import DataMesh
from roboticattack_torch.training import (
    Overwatch,
    TrainConfig,
    VLAMetrics,
    VLATrainer,
    fsdp_shardings,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    trainable_mask,
)
from roboticattack_torch.utils.prompting import WordStubTokenizer

LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
LR, STEPS = 5e-3, 6
JCFG = dataclasses.replace(J_TINY, llm=dataclasses.replace(J_TINY.llm, attn_impl="flash"))
TCFG = dataclasses.replace(VLA_TINY, llm=dataclasses.replace(VLA_TINY.llm, attn_impl="flash"))

CASES = {
    "warmup_weight_decay": dict(warmup_ratio=0.5, weight_decay=0.1, max_grad_norm=1e3),
    "clip": dict(max_grad_norm=0.05),
    "accumulate": dict(grad_accumulation_steps=2),
    "freeze_vision": dict(freeze_vision_backbone=True),
    "freeze_llm": dict(freeze_llm_backbone=True),
}


@pytest.fixture(autouse=True)
def leave_no_process_group():
    """A VLATrainer without a mesh joins a world of one in this process
    (make_mesh); leave it after each test, so later tests in the worker
    start outside any group."""
    yield
    distributed.shutdown()


@pytest.fixture(scope="module")
def setup():
    params = jax.device_get(jinit_vla_params(jax.random.key(0), J_TINY))
    it = jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=0), batch_size=4, pad_to=40)
    return params, [next(it) for _ in range(STEPS)]


def _leaves(tree) -> dict:
    return {path: np.asarray(leaf) for path, leaf in tree_leaves(tree)}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_equals_jax(setup, case, tmp_path):
    """Also: each step commits and pushes the same metrics as JAX's, and,
    as in the JAX package (strategies.py:161-172), run_training writes no
    checkpoint: the run dir holds the metrics file alone."""
    from roboticattack_tpu.training.metrics import VLAMetrics as JVLAMetrics
    from roboticattack_tpu.utils.tracking import Tracker as JTracker
    from roboticattack_torch.utils.tracking import Tracker

    params, batches = setup
    kw = dict(learning_rate=LR, max_steps=STEPS, **CASES[case])
    jt = JVLATrainer(params, JCFG, JTrainConfig(**kw), mesh=jmake_mesh(data=1, devices=jax.devices()[:1]),
                     metrics=JVLAMetrics(JTracker(str(tmp_path / "jax"), quiet=True)))
    jlosses = [jt.run_training(iter([b]), 1) for b in batches]

    start = _leaves(params)
    tt = VLATrainer(params_from_jax(params), TCFG, TrainConfig(**kw), device="cpu",
                    metrics=VLAMetrics(Tracker(str(tmp_path / "torch"), quiet=True)))
    tlosses = []
    for i, b in enumerate(batches):
        tlosses.append(tt.run_training(iter([b]), 1))
        if i < kw.get("grad_accumulation_steps", 1):  # the first update has lr 0
            for path, leaf in _leaves(tt.params).items():
                np.testing.assert_array_equal(leaf, start[path], err_msg=f"step {i + 1} moved {path}")
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)

    mask = dict(tree_leaves(trainable_mask(tt.params, tt.cfg)))
    got, want = _leaves(tt.params), _leaves(jax.device_get(jt.params))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, want[path], rtol=0, atol=PARAM_ATOL, err_msg=str(path))
        if not mask[path]:
            np.testing.assert_array_equal(leaf, start[path], err_msg=f"frozen {path} moved")
    moved = [path for path, leaf in got.items() if not np.array_equal(leaf, start[path])]
    assert moved and all(mask[p] for p in moved)
    if case in ("clip", "warmup_weight_decay"):  # the last update clipped, or did not
        assert (tt.optimizer.grad_norm >= kw["max_grad_norm"]) == (case == "clip"), tt.optimizer.grad_norm

    rows = {}
    for side in ("jax", "torch"):
        assert os.listdir(tmp_path / side) == ["run-metrics.jsonl"]
        lines = (tmp_path / side / "run-metrics.jsonl").read_text().splitlines()
        rows[side] = [{k: v for k, v in json.loads(ln).items() if k not in ("elapsed_s", "vla-train/step_time")}
                      for ln in lines]
    assert [r.pop("vla-train/loss") for r in rows["torch"]] == pytest.approx(
        [r.pop("vla-train/loss") for r in rows["jax"]], rel=LOSS_RTOL)
    assert rows["torch"] == rows["jax"] and len(rows["jax"]) == STEPS


def test_bf16_weights_lose_small_steps_as_jax(setup):
    """A held JAX behaviour: bf16 weights and no f32 master copy, so
    p = (p + u).astype(bf16) drops an Adam step below half an ulp. At lr
    2e-5 (the reference's rate) the second step (the first at lr > 0)
    changes a minority of the LLM's elements, the same share in both
    packages (within 0.02: the bf16 forwards round apart)."""
    cfg = dataclasses.replace(J_TINY, dtype="bfloat16")
    params = jax.device_get(jinit_vla_params(jax.random.key(0), cfg))
    kw = dict(learning_rate=2e-5, max_steps=STEPS)
    jt = JVLATrainer(params, cfg, JTrainConfig(**kw), mesh=jmake_mesh(data=1, devices=jax.devices()[:1]))
    tt = VLATrainer(params_from_jax(params), dataclasses.replace(VLA_TINY, dtype="bfloat16"),
                    TrainConfig(**kw), device="cpu")
    for b in setup[1][:2]:
        jt.run_training(iter([b]), 1)
        tt.run_training(iter([b]), 1)
    start = {p: np.asarray(a, np.float32) for p, a in tree_leaves(params) if p[0] == "llm"}
    shares = {}
    for side, tree in (("jax", jax.device_get(jt.params)), ("torch", tt.params)):
        got = {p: np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
               for p, a in tree_leaves(tree) if p[0] == "llm"}
        shares[side] = sum((got[p] != a).sum() for p, a in start.items()) / sum(a.size for a in start.values())
    assert 0.05 < shares["torch"] < 0.5 and abs(shares["torch"] - shares["jax"]) < 0.02, shares


def _batches(bs=8):
    frames = dummy_frame_iterator(WordStubTokenizer(), image_size=56, seed=0)
    return batch_iterator(frames, batch_size=bs, pad_to=48)


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_training_reduces_loss(strategy):
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY)
    cfg = TrainConfig(strategy=strategy, learning_rate=5e-3, max_steps=12, warmup_ratio=0.0, seed=0)
    trainer = VLATrainer(params, VLA_TINY, cfg, device="cpu")
    batches = _batches(bs=8)
    first = trainer.run_training(batches, num_steps=1)
    last = trainer.run_training(batches, num_steps=11)
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (first, last)


@pytest.mark.parametrize("vision,llm", [(False, False), (True, False), (False, True), (True, True)])
def test_freeze_masks(setup, vision, llm):
    params = setup[0]
    kw = dict(freeze_vision_backbone=vision, freeze_llm_backbone=llm)
    mask = trainable_mask(params_from_jax(params), TrainConfig(**kw))
    want = dict(tree_leaves(jax.device_get(jtrainable_mask(params, JTrainConfig(**kw)))))
    got = dict(tree_leaves(mask))
    assert got == {path: bool(v) for path, v in want.items()}
    assert all(v is (not vision) for p, v in got.items() if p[0] == "vision")
    assert all(v is (not llm) for p, v in got.items() if p[0] == "llm")
    assert all(v for p, v in got.items() if p[0] == "projector")


def test_frozen_params_do_not_move():
    params = init_vla_params(torch.Generator().manual_seed(2), VLA_TINY)
    cfg = TrainConfig(strategy="ddp", learning_rate=5e-3, max_steps=3, freeze_vision_backbone=True)
    before = {p: t.clone() for p, t in tree_leaves(params)}
    trainer = VLATrainer(params, VLA_TINY, cfg, device="cpu")
    trainer.run_training(_batches(bs=8), num_steps=3)
    after = dict(tree_leaves(trainer.params))
    for path, t in before.items():
        assert torch.equal(after[path], t) == (path[0] == "vision"), path


def test_checkpoint_roundtrip(tmp_path):
    params = init_vla_params(torch.Generator().manual_seed(3), VLA_TINY)
    opt = {"mu": {"w": torch.randn(3, 2)}, "count": 7}
    path = save_checkpoint(str(tmp_path), step=42, epoch=1, params=params, opt_state=opt, loss=1.234)
    assert os.path.basename(path) == "step-000042-epoch-01-loss=1.2340"
    assert os.path.realpath(tmp_path / "latest-checkpoint") == path == latest_checkpoint(str(tmp_path))
    restored = restore_checkpoint(str(tmp_path / "latest-checkpoint"))
    got = dict(tree_leaves(restored["params"]))
    for key, leaf in tree_leaves(params):
        assert got[key].device.type == "cpu" and torch.equal(got[key], leaf), key
    assert torch.equal(restored["opt_state"]["mu"]["w"], opt["mu"]["w"]) and restored["opt_state"]["count"] == 7

    # a newer save replaces the link; numpy leaves come back as numpy
    arr = np.arange(6, dtype=np.float64).reshape(2, 3)
    newer = save_checkpoint(str(tmp_path), step=43, params={"a": arr, "best": 0.5})
    assert os.path.basename(newer) == "step-000043-epoch-00"
    assert latest_checkpoint(str(tmp_path)) == newer
    again = restore_checkpoint(newer)
    assert "opt_state" not in again and again["params"]["best"] == 0.5
    assert isinstance(again["params"]["a"], np.ndarray) and np.array_equal(again["params"]["a"], arr)
    assert sorted(os.listdir(tmp_path)) == ["latest-checkpoint", "step-000042-epoch-01-loss=1.2340",
                                            "step-000043-epoch-00"]
    assert latest_checkpoint(str(tmp_path / "nothing")) is None


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_shardings_equal_jax_on_the_7b(n):
    shapes = jax.eval_shape(lambda k: jinit_vla_params(k, J_7B), jax.random.key(0))
    want = jfsdp_shardings(shapes, jmake_mesh(data=n, devices=jax.devices()[:n]))
    meta = tree_from_leaves((path, torch.empty(s.shape, device="meta")) for path, s in tree_leaves(shapes))
    got = dict(tree_leaves(fsdp_shardings(meta, DataMesh(None, 0, n, torch.device("cpu")))))
    want = {path: tuple(s.spec) for path, s in tree_leaves(want)}
    assert len(got) == len(want) > 40
    assert {p: tuple(s) for p, s in got.items()} == want
    # the tie order of np.argsort: a [32, 4096, 4096] stack splits its last dim
    assert got[("llm", "layers", "q_w")] == (None, None, "data")


def test_metrics_push_equals_jax(tmp_path):
    from roboticattack_tpu.training.metrics import VLAMetrics as JVLAMetrics
    from roboticattack_tpu.utils.tracking import Tracker as JTracker
    from roboticattack_torch.utils.tracking import Tracker

    jm = JVLAMetrics(JTracker(str(tmp_path / "jax"), quiet=True), window=3)
    tm = VLAMetrics(Tracker(str(tmp_path / "torch"), quiet=True), window=3)
    tm.epoch = jm.epoch = 2
    for i, loss in enumerate([3.0, 2.5, 2.0, 1.5, 1.25]):
        for m in (jm, tm):
            m.commit(loss=loss, lr=1e-3 * i, update_step_time=True, grad_norm=0.1 * i)
            m.commit_for_dataset("bridge", loss + 1.0)
            if i % 2:
                m.commit_for_dataset("libero", loss)
        want, got = jm.push(), tm.push()
        assert got.pop("vla-train/step_time") >= 0 and want.pop("vla-train/step_time") >= 0
        assert got == want and got["vla-train/step"] == i
    lines = {}
    for side in ("jax", "torch"):
        rows = [json.loads(ln) for ln in (tmp_path / side / "run-metrics.jsonl").read_text().splitlines()]
        lines[side] = [{k: v for k, v in r.items() if k not in ("elapsed_s", "vla-train/step_time")} for r in rows]
    assert lines["torch"] == lines["jax"] and len(lines["jax"]) == 5


def test_overwatch_gates_on_rank_zero(monkeypatch):
    from roboticattack_tpu.training.overwatch import Overwatch as JOverwatch
    from roboticattack_torch.parallel import distributed
    from roboticattack_torch.parallel.distributed import DistInfo

    ow = Overwatch("test_overwatch_rank0")
    assert ow.logger.level == JOverwatch("test_overwatch_jax").logger.level == logging.INFO
    assert ow.is_rank_zero() and ow.rank_zero_only(lambda: 5)() == 5

    monkeypatch.setattr(distributed, "current", lambda: DistInfo("gloo", 1, 2, 1, torch.device("cpu")))
    ow1 = Overwatch("test_overwatch_rank1")
    assert ow1.logger.level == logging.ERROR
    assert (ow1.rank, ow1.world_size) == (1, 2) and not ow1.is_rank_zero()
    assert ow1.rank_zero_only(lambda: 5)() is None


def test_chip_smoke_train_phase_on_the_cpu(monkeypatch):
    """chip_smoke.phase_train rehearsed on the CPU at a tiny size (vla-tiny
    with flash attention and remat): the 7B step's checks (step 1
    bit-equal, the loss falling over steps 2-4, the frozen towers, B1/B2
    launches a step counted on their plain versions, the gradients against
    plain attention), the rank model in one process, and the phase's
    checks of the ranks' lines. The torch.cuda calls, the profiler, the
    tiny train-then-attack (tests/test_torch_integration_attack.py runs it)
    and the torchrun job (two ranks of the same step in this process) are
    stubbed: the CPU has no card."""
    import chip_smoke
    from roboticattack_torch.models.config import REGISTRY
    from roboticattack_torch.ops import flash_attention as fa

    tiny = dataclasses.replace(VLA_TINY, name="vla-tiny-flash-remat", remat=True,
                               llm=dataclasses.replace(VLA_TINY.llm, attn_impl="flash"))
    monkeypatch.setitem(REGISTRY, tiny.name, tiny)
    for name, value in (("MODEL", tiny.name), ("DEVICE", "cpu"), ("TRAIN_CHECK_LAYER", 1),
                        ("TRAIN_LR", 5e-3)):
        monkeypatch.setattr(chip_smoke, name, value)
    for kind in ("fwd", "bwd"):  # the plain versions launch nothing: count their calls
        plain = getattr(fa, f"flash_attention_{kind}_plain")

        def counted(*a, _plain=plain, _kind=kind, **k):
            fa.flash_attention.launches[_kind] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(fa, f"flash_attention_{kind}_plain", counted)
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None), ("max_memory_allocated", 0),
                        ("memory_allocated", 0), ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    monkeypatch.setattr(chip_smoke, "device_profile", lambda run, *a, **k: run() or {"busy": "not measured"})
    tiny_result = {"final_loss": 0.1, "train_s": 1.0, "baseline_success": 0.0, "clean_ce": 4.0,
                   "attacked_success": 0.5, "attacked_ce": 0.5, "clean_mean": -0.8, "patched_mean": 0.1,
                   "int4_default": {"f32, int4": {"int4_kernel": False, "action": [0.0] * 7}}}
    monkeypatch.setattr(chip_smoke, "train_then_attack", lambda device: tiny_result)

    def two_ranks(nproc):
        run = {s: chip_smoke.rank_training(chip_smoke.rank_model(), s) for s in ("ddp", "fsdp")}
        return 0, 1.0, {r: {"backend": "gloo", "device": "cpu", **run} for r in range(nproc)}, ""

    monkeypatch.setattr(chip_smoke, "torchrun_train", two_ranks)
    torch.manual_seed(0)
    out = chip_smoke.phase_train("CPU")
    layers = tiny.llm.num_layers
    assert out["launches"] == [{"fwd": 2 * layers, "bwd": layers}] * chip_smoke.TRAIN_STEPS
    assert out["losses"][1] > out["losses"][2] > out["losses"][3] and 0 < out["changed"] <= 1
    assert out["ranks"] == {r: {"ddp": {"fwd": 4, "bwd": 2}, "fsdp": {"fwd": 4, "bwd": 2}} for r in (0, 1)}
    assert out["reckon"]["trainable_params"] > 0 and min(out["against"]["cos"].values()) >= 0.99


def test_trainer_raises_without_cuda(monkeypatch):
    """The trainer runs on CUDA unless given device="cpu": without a GPU
    the default raises before it joins a process group or touches a leaf."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VLATrainer(params, VLA_TINY, TrainConfig())
