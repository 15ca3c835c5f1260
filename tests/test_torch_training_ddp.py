"""The port's trainer on two gloo ranks (tests/torch_ddp_workers.py
train_rank), ddp and then fsdp in one spawn, against the port in one
process and the JAX package's `VLATrainer` on `make_mesh(data=2)`.

The run clips (max_grad_norm 0.05), decays weights and warms up, so the
fsdp step's norm over the shards is what decides each update. Per step
ddp calls two all-reduces (the loss's sums, the gradients in one flat
buffer) and fsdp one all-gather (the shards, one flat buffer) and three
all-reduces (the sums, the gradients, the shards' part of the norm);
building either trainer broadcasts every leaf once from rank 0.

Tolerances: the ranks equal each other, and ddp equals fsdp, bit for bit;
against one process and against JAX, losses rtol 1e-5 and every parameter
element within 1e-5 absolute (f32 sums over other row splits, through 4
Adam steps at lr 5e-3)."""

import numpy as np
import jax
import pytest
import torch

from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.training import TrainConfig as JTrainConfig
from roboticattack_tpu.training import VLATrainer as JVLATrainer
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.param_tree import tree_leaves
from roboticattack_torch.parallel import distributed
from roboticattack_torch.training import TrainConfig, VLATrainer
from torch_ddp_workers import start_ranks, train_rank, wait_ranks

RTOL, ATOL = 1e-5, 1e-5
STEPS = 4
TRAIN = dict(learning_rate=5e-3, weight_decay=0.1, warmup_ratio=0.34, max_grad_norm=0.05, max_steps=STEPS)


@pytest.fixture(autouse=True)
def leave_no_process_group():
    """A VLATrainer without a mesh joins a world of one in this process
    (make_mesh); leave it after each test, so later tests in the worker
    start outside any group."""
    yield
    distributed.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ddp")
    jparams = jax.device_get(jinit_vla_params(jax.random.key(0), J_TINY))
    it = jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=3), batch_size=4, pad_to=40)
    batches = [next(it) for _ in range(STEPS)]
    payload = str(tmp / "payload.pt")
    torch.save({"params": params_from_jax(jparams), "batches": batches, "train": TRAIN,
                "model_cfg": VLA_TINY}, payload)
    ctx = start_ranks(train_rank, 2, 2, f"file://{tmp / 'store'}", payload, str(tmp))
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        single, jax_runs = {}, {}
        for strategy in ("ddp", "fsdp"):
            t = VLATrainer(params_from_jax(jparams), VLA_TINY, TrainConfig(strategy=strategy, **TRAIN), device="cpu")
            single[strategy] = ([t.run_training(iter([b]), 1) for b in batches], dict(tree_leaves(t.params)))
            j = JVLATrainer(jparams, J_TINY, JTrainConfig(strategy=strategy, **TRAIN),
                            mesh=jmake_mesh(data=2, devices=jax.devices()[:2]))
            jax_runs[strategy] = ([j.run_training(iter([b]), 1) for b in batches],
                                  dict(tree_leaves(jax.device_get(j.params))))
        torch.set_num_threads(threads)
    finally:
        wait_ranks(ctx)
    ranks = [torch.load(tmp / f"train_rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, single, jax_runs, dict(tree_leaves(jparams))


def _close(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(np.asarray(t), np.asarray(want[path]), rtol=0, atol=ATOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_two_ranks_equal_one_process_and_jax(runs, strategy):
    ranks, single, jax_runs, start = runs
    r0, r1 = ranks[0][strategy], ranks[1][strategy]
    assert r0["losses"] == r1["losses"]
    for path, t in r0["params"].items():
        assert torch.equal(t, r1["params"][path]), path
        assert torch.equal(t, ranks[0]["ddp"]["params"][path]), f"fsdp differs from ddp at {path}"
    np.testing.assert_allclose(r0["losses"], single[strategy][0], rtol=RTOL)
    np.testing.assert_allclose(r0["losses"], jax_runs[strategy][0], rtol=RTOL)
    _close(r0["params"], single[strategy][1], "one process")
    _close(r0["params"], jax_runs[strategy][1], "jax")
    moved = [p for p, t in r0["params"].items() if not np.array_equal(t.numpy(), start[p])]
    assert len(moved) == len(start)  # nothing frozen: every leaf trains


def test_collectives_per_step(runs):
    ranks, _, _, start = runs
    n_params = sum(a.size for a in start.values())
    for r in ranks:
        for strategy in ("ddp", "fsdp"):
            assert [name for name, _ in r[strategy]["init"]] == ["broadcast"] * len(start)
        for log in r["ddp"]["collectives"]:
            assert log == [("all_reduce", (2,)), ("all_reduce", (n_params,))]
        kept = sum(int(np.prod(s)) for s in r["fsdp"]["kept"].values())
        whole = sum(a.size for p, a in start.items() if r["fsdp"]["kept"][p] == a.shape)
        assert kept == whole + (n_params - whole) // 2 and whole < n_params // 50
        for log in r["fsdp"]["collectives"]:
            assert [name for name, _ in log] == ["all_gather", "all_reduce", "all_reduce", "all_reduce"]
            assert log[0][1] == (kept - whole,) and log[1:] == [("all_reduce", (2,)), ("all_reduce", (n_params,)),
                                                                 ("all_reduce", ())]
