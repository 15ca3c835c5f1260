"""The port's data-parallel attack on the CPU over gloo, two ranks spawned
per check (tests/torch_ddp_workers.py), against the port's single-process
step and the JAX package's sharded steps on a two-device CPU mesh.

- gspmd: two ranks' outer step (tma, uada without +1/CE, upa; geometry on,
  two inner steps) equals the single-process step on the whole batch and
  JAX `make_attack_step` on a batch sharded over `make_mesh(data=2)`, and
  their val step the single-process val step on the whole batch;
  per inner step one patch-shaped all-reduce, one all-reduce of the packed
  scalar sums, and no gather (the JAX HLO test's counterpart).
- exact: equals JAX `make_ddp_attack_step` with its per-device draws
  replayed, on a batch whose rank-1 rows hold fewer valid label tokens,
  where the two semantics differ.
- the runner and the CLI: rank 0 writes every file, rank 1 none; patches,
  best and histories equal across ranks; the val metrics equal one
  process's on the whole val batch; matching patch hashes at the end.
- initialize_multihost: torchrun's environment, a world of one, gloo on
  the CPU.

Tolerances: rtol 1e-5 / atol 1e-6 (f32 sums taken over other row splits)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.attacks import engine as je
from roboticattack_tpu.attacks.ddp import make_ddp_attack_step as jmake_ddp_step
from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.parallel import replicate as jreplicate
from roboticattack_tpu.parallel import shard_batch as jshard_batch
from roboticattack_tpu.utils.labels import build_tma_target_tokens
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.attacks import engine as te
from roboticattack_torch.attacks.attacker import AttackConfig, OpenVLAAttacker
from roboticattack_torch.attacks.optimizer import adam_init
from roboticattack_torch.cli import attack as cli
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.parallel import distributed
from roboticattack_torch.utils.constants import IGNORE_INDEX
from test_torch_attack_step import PATCH_HW, _replay_step, _torch_state
from test_torch_patch_ops import replay_patch_draws
from torch_ddp_workers import run_ranks, runner_rank, start_ranks, steps_rank, tiny_batches, val_draws, wait_ranks

RTOL, ATOL = 1e-5, 1e-6
ALL = [0, 1, 2, 3, 4, 5, 6]
LR = 2e-3


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _uneven(batch):
    """rank 1's rows (2 and 3 of 4) lose their first three valid labels."""
    labels = np.array(batch.labels)
    for row in (2, 3):
        labels[row, np.flatnonzero(labels[row] != IGNORE_INDEX)[:3]] = IGNORE_INDEX
    return batch._replace(labels=labels)


def _replay_exact(rng, spec, batch, world=2):
    """JAX ddp.py's per-device draws: split(rng) -> (k_label, k_inner); each
    inner key and the label key folded with the device index."""
    k_label, k_inner = jax.random.split(rng)
    b, h, w, _ = batch.images.shape
    keys = jax.random.split(k_inner, spec.inner_loop)
    out = []
    for d in range(world):
        inner = [replay_patch_draws(jax.random.fold_in(k, d), b // world, h, w, *PATCH_HW, spec.resize_patch)
                 for k in keys]
        coin = None
        if spec.objective == "upa_guide":
            shape = (batch.labels.shape[0] // world, batch.labels.shape[1])
            coin = torch.from_numpy(np.array(jax.random.bernoulli(jax.random.fold_in(k_label, d), 0.5, shape)))
        out.append(te.StepDraws(inner=inner, coin=coin))
    return out


GSPMD = {  # name -> (spec, maskidx)
    "tma": (dict(objective="tma"), ALL),
    "uada": (dict(objective="uada", add_inverse_ce=False), ALL),
    "upa": (dict(objective="upa", grad_clip_l1=1e-3), ALL),
}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every step case through two spawned ranks, and meanwhile the port's
    single process and the JAX package's two-device mesh."""
    tmp = tmp_path_factory.mktemp("ddp_steps")
    jparams = jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))
    tparams = params_from_jax(jparams)
    batch = next(jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=1), batch_size=4, pad_to=48))
    uneven = _uneven(batch)
    jstate = jax.device_get(je.init_attack_state(jax.random.key(2), PATCH_HW))
    rng = jax.random.key(11)
    cases = {}
    for name, (kw, maskidx) in GSPMD.items():
        spec_kw = dict(kw, inner_loop=2, geometry=True)
        target = build_tma_target_tokens(np.zeros(7), maskidx) if kw["objective"] == "tma" else None
        for bname, b in (("", batch), ("_uneven", uneven)):
            if not bname or name == "uada":
                cases[f"gspmd_{name}{bname}"] = dict(
                    semantics="gspmd", spec=spec_kw, maskidx=maskidx, target=target, batch=b, lr=LR,
                    draws=_replay_step(rng, te.AttackSpec(**spec_kw), b))
    spec_kw = dict(objective="uada", add_inverse_ce=False, inner_loop=2, geometry=True)
    cases["exact_uada_uneven"] = dict(semantics="exact", spec=spec_kw, maskidx=ALL, target=None, batch=uneven,
                                      draws=_replay_exact(rng, te.AttackSpec(**spec_kw), uneven), lr=LR)
    payload = str(tmp / "payload.pt")
    torch.save({"params": tparams, "state": _torch_state(jstate), "cases": cases}, payload)
    ctx = start_ranks(steps_rank, 2, 2, f"file://{tmp / 'store'}", payload, str(tmp))

    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    jax_out, single, jsteps = {}, {}, {}
    for name, c in cases.items():
        jspec = je.AttackSpec(**c["spec"])
        jstate_mesh = jreplicate(jax.tree.map(jnp.asarray, jstate), mesh)
        args = (jreplicate(jparams, mesh), jstate_mesh, jshard_batch(c["batch"], mesh), jnp.float32(LR))
        if c["semantics"] == "exact":
            jst, jm = jmake_ddp_step(jspec, J_TINY, None, ALL, mesh)(*args, rng)
        else:
            key = (c["spec"]["objective"],)
            if key not in jsteps:  # the uneven batch reuses uada's compiled step
                jsteps[key] = je.make_attack_step(jspec, J_TINY, c["target"], c["maskidx"])
            jst, jm = jsteps[key](*args, jnp.bool_(True), rng)
            tstep = te.make_attack_step(te.AttackSpec(**c["spec"]), VLA_TINY, c["target"], c["maskidx"])
            tbatch = te.batch_to_device(c["batch"], "cpu")
            sst, sm = tstep(tparams, _torch_state(jstate), tbatch, LR, True, c["draws"])
            tval = te.make_val_step(te.AttackSpec(**c["spec"]), VLA_TINY, c["target"], c["maskidx"])
            single[name] = (sst.patch.numpy(), {k: v.numpy() for k, v in sm.items()},
                            tval(tparams, _torch_state(jstate).patch, tbatch, val_draws(c["draws"])))
        jax_out[name] = (np.asarray(jst.patch), {k: np.asarray(v) for k, v in jm.items()})
    wait_ranks(ctx)
    ranks = [torch.load(tmp / f"steps_rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, jax_out, single


def _got(ranks, name):
    st, m = ranks[0][name]["state"], ranks[0][name]["metrics"]
    return st.patch.numpy(), {k: v.numpy() for k, v in m.items()}


@pytest.mark.parametrize("name", ["gspmd_tma", "gspmd_uada", "gspmd_upa", "gspmd_uada_uneven"])
def test_gspmd_two_ranks_equal_one_process_and_jax(steps, name):
    ranks, jax_out, single = steps
    patch, metrics = _got(ranks, name)
    for r in (1,):  # the replicas agree bit for bit
        assert np.array_equal(ranks[r][name]["state"].patch.numpy(), patch)
        assert all(torch.equal(ranks[r][name]["metrics"][k], ranks[0][name]["metrics"][k]) for k in metrics)
    for ref_name, (ref_patch, ref_metrics) in (("one process", single[name][:2]), ("jax", jax_out[name])):
        assert sorted(metrics) == sorted(ref_metrics), ref_name
        for k in ref_metrics:
            assert metrics[k].shape == (2,)
            close(metrics[k], ref_metrics[k], f"{name} {k} vs {ref_name}")
        close(patch, ref_patch, f"{name} patch vs {ref_name}")


@pytest.mark.parametrize("name", ["gspmd_tma", "gspmd_uada", "gspmd_upa", "gspmd_uada_uneven"])
def test_gspmd_val_step_two_ranks_equal_one_process(steps, name):
    """Every rank holds what one process computes on the whole batch: the
    scalars from the reduced sums, the per-example entries gathered; the
    patched images stay each rank's rows."""
    ranks, _, single = steps
    want = single[name][2]
    for r in range(2):
        got = ranks[r][name]["val"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k == "_patched_images":
                close(got[k], v[r * 2:(r + 1) * 2], f"{name} rank {r} {k}")
            else:
                assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
                close(got[k], v, f"{name} rank {r} val {k}")


@pytest.mark.parametrize("name", ["gspmd_tma", "gspmd_uada", "gspmd_upa"])
def test_gspmd_traffic_is_one_patch_and_one_packed_allreduce_per_inner_step(steps, name):
    ranks, _, _ = steps
    for r in range(2):
        log = ranks[r][name]["collectives"]
        patch = [c for c in log if c == ("all_reduce", (*PATCH_HW, 3))]
        packed = [c for c in log if c[0] == "all_reduce" and len(c[1]) == 1]
        assert len(patch) == 2 and len(packed) == 2 and len(log) == 4, log
        assert not any(c[0] == "all_gather" for c in log)


def test_exact_equals_jax_ddp_where_the_semantics_differ(steps):
    ranks, jax_out, _ = steps
    patch, metrics = _got(ranks, "exact_uada_uneven")
    assert np.array_equal(ranks[1]["exact_uada_uneven"]["state"].patch.numpy(), patch)
    want_patch, want_metrics = jax_out["exact_uada_uneven"]
    assert sorted(metrics) == sorted(want_metrics)
    for k in want_metrics:
        close(metrics[k], want_metrics[k], f"exact {k}")
    close(patch, want_patch, "exact patch")
    # on this batch the token-count weighting separates the semantics
    g_patch, g_metrics = _got(ranks, "gspmd_uada_uneven")
    for a, b in ((metrics["loss"], g_metrics["loss"]), (patch, g_patch)):
        assert np.abs(a - b).max() > ATOL + RTOL * np.abs(b).max()
    log = ranks[0]["exact_uada_uneven"]["collectives"]
    assert [c[0] for c in log] == ["all_reduce"] * 4 and log[0] == ("all_reduce", (*PATCH_HW, 3))


# ------------------------------------------------------------------ runner
RUN = dict(objective="uada", maskidx=ALL, lr=1e-2, num_iter=3, batch_size=8, warmup=0, inner_loop=1,
           geometry=False, add_inverse_ce=False, eval_every=2, eval_batches=1, patch_size=(3, 10, 10))
RUNS = {  # name -> (semantics, AttackConfig fields, params)
    "gspmd": ("gspmd", RUN, "params"),
    "exact": ("exact", RUN, "params"),
    # the paper's TMA on the gripper: the train batches' open-gripper filter
    # and the val step's clean-image filter, on weights whose clean gripper
    # predictions are right for some rows of each rank and wrong for others
    "tma_grip": ("gspmd", dict(RUN, objective="tma", maskidx=[6], filter_grip_train_to_1=True), "grip_params"),
    "upa": ("gspmd", dict(RUN, objective="upa"), "params"),
}
OPEN, CLOSE = 31744, 31999  # the gripper's +1 and -1 tokens


def _gripper_params(params):
    """Every position predicts OPEN or CLOSE by the sign of its first
    hidden unit: the final norm keeps that unit alone, and the head maps it
    to +OPEN / -CLOSE."""
    llm = dict(params["llm"], norm=torch.zeros_like(params["llm"]["norm"]),
               lm_head=torch.zeros_like(params["llm"]["lm_head"]))
    llm["norm"][0] = 1.0
    llm["lm_head"][0, OPEN], llm["lm_head"][0, CLOSE] = 1.0, -1.0
    return dict(params, llm=llm)


TINY = ["--attack", "uada", "--model", "vla-tiny", "--device", "cpu", "--dataset", "dummy", "--iter", "3",
        "--innerLoop", "1", "--bs", "2", "--eval_batches", "1", "--maskidx", "0,1,2,3,4,5,6"]


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    """Two spawned ranks: the runs of RUNS (a file store), then
    `cli.attack --data_parallel true` as torchrun ranks."""
    tmp = tmp_path_factory.mktemp("ddp_runner")
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu")
    weights = {"params": params, "grip_params": _gripper_params(params)}
    payload = str(tmp / "payload.pt")
    torch.save({**weights, "attack": RUN, "runs": RUNS}, payload)
    (tmp / "cli").mkdir()
    run_ranks(runner_rank, 2, 2, f"file://{tmp / 'store'}", payload, str(tmp), [*TINY, "--data_parallel", "true"])
    ranks = [torch.load(tmp / f"runner_rank{r}.pt", weights_only=False) for r in range(2)]
    return tmp, weights, ranks


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_two_ranks(runner, name):
    tmp, weights, ranks = runner
    sem, attack, params_key = RUNS[name]
    params, cfg = weights[params_key], AttackConfig(**attack)
    out = tmp / name
    for tag in ("final", "last", "0"):
        for f in ("patch.pt", "patch.png", "patch.npy"):
            assert (out / tag / f).is_file(), f"{tag}/{f}"
    assert len(list((out / "last" / "val_related_data").glob("*.png"))) == 8  # the global val batch
    assert sorted(os.listdir(out / "attack_state")) == [
        "latest-checkpoint", "step-000000-epoch-00", "step-000002-epoch-00"]
    lines = [json.loads(ln) for ln in (out / "run-metrics.jsonl").read_text().splitlines()]
    train = [ln for ln in lines if "TRAIN_loss" in ln]
    assert [ln["step"] for ln in train] == [0, 1, 2]  # one writer
    if attack["objective"] == "uada":
        assert all(ln["TRAIN_loss"] == ln["TRAIN_mse_distance"] for ln in train)
    assert not (tmp / f"{name}_rank1").exists(), "rank 1 wrote under its run dir"
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["writes"] > 0 and r1["writes"] == 0
    assert np.isfinite(r0["best"]) and r0["best"] == r1["best"] and r0["histories"] == r1["histories"]
    assert np.array_equal(r0["patch"], r1["patch"])
    # the last eval (step 2) scored the final patch on the second val batch:
    # one process on the whole batch gives the same metrics
    single = OpenVLAAttacker(params, VLA_TINY, str(tmp / f"single_{name}"), cfg)
    val = tiny_batches(8, 1)
    next(val)
    batch = next(val)
    if name == "tma_grip":  # the clean filter keeps some rows of each rank and drops others
        kept = single._clean_val(params, te.batch_to_device(batch, "cpu")).numpy()
        assert kept[:4].any() and kept[4:].any() and not kept.all(), kept
        assert {"val_l1", "ALL_ASR_6", "ASR_02other"} <= set(r0["histories"])
    patch = torch.from_numpy(r0["patch"])
    single._validate(te.AttackState(patch=patch, opt=adam_init(patch), grad_acc=torch.zeros_like(patch)),
                     iter([batch]), 2)
    assert single.histories and all(k in r0["histories"] for k in single.histories)
    for k, v in single.histories.items():
        close(r0["histories"][k][-1], v[-1], f"{name} {k}")
    if sem == "gspmd":  # and the whole run is one process's
        res = OpenVLAAttacker(params, VLA_TINY, str(tmp / f"single_run_{name}"), cfg).run(
            tiny_batches(8, 0), tiny_batches(8, 1))
        close(r0["patch"], res.patch, f"{name} final patch vs one process")
        for k, v in res.histories.items():
            close(r0["histories"][k], v, f"{name} {k} history vs one process")


def test_runner_resume_broadcasts_rank_zeros_state(runner):
    tmp, _, ranks = runner
    r0, r1 = ranks[0]["resume"], ranks[1]["resume"]
    assert np.array_equal(r0["patch"], r1["patch"]) and r0["histories"] == r1["histories"]
    assert r0["best"] == r1["best"] == ranks[0]["gspmd"]["best"]
    before = ranks[0]["gspmd"]["histories"]["train_CE_loss"]
    assert r0["histories"]["train_CE_loss"][:-1] == before and len(before) == 3
    assert not r0["patch"].tobytes() == ranks[0]["gspmd"]["patch"].tobytes()
    assert (tmp / "resume" / "final" / "patch.pt").is_file() and not (tmp / "resume_rank1").exists()


def test_exact_without_a_mesh_raises(tmp_path):
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu")
    with pytest.raises(ValueError, match="data mesh"):
        OpenVLAAttacker(params, VLA_TINY, str(tmp_path), AttackConfig(objective="uada", ddp_semantics="exact"))
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------------ CLI


def test_data_parallel_flag_maps_to_the_ddp_variant(tmp_path, monkeypatch):
    """A world of one: +1/CE dropped, eval every 200, the semantics passed;
    the process group the CLI formed is gone after it."""
    from roboticattack_torch.attacks import attacker

    seen = []
    init = attacker.OpenVLAAttacker.__init__

    def spy(self, params, cfg, save_dir, attack, **kw):
        seen.append((attack, kw["mesh"]))
        init(self, params, cfg, save_dir, attack, **kw)

    monkeypatch.setattr(attacker.OpenVLAAttacker, "__init__", spy)
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    writes = []
    out = io.StringIO()
    monkeypatch.setattr(out, "write", lambda text: writes.append(text) or len(text))
    with contextlib.redirect_stdout(out):
        cli.main([*TINY, "--data_parallel", "true", "--ddp_semantics", "exact", "--output", str(tmp_path / "dp")])
    # the rank line is one write, newline included: ranks share a stdout pipe
    (line,) = [w for w in writes if "ddp rank" in w]
    assert line.startswith("ddp rank 0/1: {") and line.endswith("}\n")
    cli.main([*TINY, "--ddp_semantics", "exact", "--output", str(tmp_path / "one")])
    (dp, mesh), (one, no_mesh) = seen
    assert (dp.add_inverse_ce, dp.eval_every, dp.ddp_semantics) == (False, 200, "exact")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    # without --data_parallel the JAX CLI ignores --ddp_semantics
    assert (one.add_inverse_ce, one.eval_every, one.ddp_semantics, no_mesh) == (True, 100, "gspmd", None)
    assert not torch.distributed.is_initialized()
    lines = [json.loads(ln) for ln in (tmp_path / "dp" / "run-metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines if any(k.startswith("VAL_") for k in ln)] == [0]


def test_two_rank_cli_run_from_the_torchrun_environment(runner):
    """Two ranks rendezvous through MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE on gloo, share rank 0's run dir (no --output: run/uada/<rank
    0's exp id>) and end with equal patch hashes."""
    tmp_path = runner[0] / "cli"
    outs = [(tmp_path / f"stdout_rank{r}.txt").read_text() for r in range(2)]
    assert "torch.distributed initialized: backend gloo, rank 0/2, device cpu" in outs[0]
    assert "torch.distributed initialized" not in outs[1] and "[step" not in outs[1]
    digests = []
    for r, text in enumerate(outs):
        (line,) = [ln for ln in text.splitlines() if ln.startswith(f"ddp rank {r}/2: ")]
        info = json.loads(line.split(": ", 1)[1])
        assert (info["rank"], info["world"], info["backend"]) == (r, 2, "gloo")
        assert (info["writes"] > 0) == (r == 0), info["writes"]
        digests.append(info["patch_sha256"])
    assert re.fullmatch(r"[0-9a-f]{64}", digests[0]) and digests[0] == digests[1]
    (run_dir,) = os.listdir(tmp_path / "run" / "uada")
    assert f"exp_id:{run_dir}" in outs[0]
    assert (tmp_path / "run" / "uada" / run_dir / "final" / "patch.pt").is_file()


def test_chip_smoke_reads_rank_lines_that_other_output_runs_into():
    """Two ranks on one stdout pipe: a print's text and newline are two
    writes, so a rank's line may start after, or run into, another rank's
    text (as on the card: rank 1's line, then rank 0's step line, then the
    newline)."""
    import chip_smoke

    r1 = {"rank": 1, "flash_attention_launches": {"fwd": 448, "bwd": 192}, "writes": 0}
    r0 = {"rank": 0, "flash_attention_launches": {"fwd": 448, "bwd": 192}, "writes": 19}
    out = (f"torch.distributed initialized: backend gloo\nddp rank 1/2: {json.dumps(r1)}[step 2] VAL_val_ce=10.996\n\n"
           f"[step 2] VAL_val_uad=0.76ddp rank 0/2: {json.dumps(r0)}\n")
    assert chip_smoke.rank_lines(out) == {0: r0, 1: r1}
    assert chip_smoke.rank_lines("ddp rank 0/2: not json\n") == {}


def test_initialize_multihost_forms_a_world_of_one_on_gloo(monkeypatch):
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    try:
        info = distributed.initialize_multihost(device="cpu")
        assert (info.backend, info.rank, info.world_size, info.device.type) == ("gloo", 0, 1, "cpu")
        assert distributed.initialize_multihost(device="cpu") is info  # once per process
        t = torch.ones(3)
        torch.distributed.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo")])
def test_backend_rule(device, local, cards, want):
    assert distributed.backend_for(device, local, cards) == want


def test_mesh_helpers_refuse_what_they_cannot_do():
    from roboticattack_torch.parallel import mesh as tmesh

    m = tmesh.DataMesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    assert tmesh.shard_batch({"a": np.arange(8), "b": None}, m)["a"].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not split evenly"):
        tmesh.shard_batch(np.arange(5), m)
    # the model axis is ported: a world of one is refused as not data x model
    with pytest.raises(ValueError, match="needs a world of data x model processes"):
        tmesh.make_mesh(model=2)
