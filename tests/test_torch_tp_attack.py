"""The port's attack step under a model axis on the CPU over gloo: two ranks
at tp=2 and four at dp=2 x tp=2, spawned once for the module
(tests/torch_tp_workers.py `tp_attack_rank`, no JAX in the ranks), against
the port's one process and the JAX package's `make_attack_step` on
`make_mesh(data, model=2)` with `shard_params` (GSPMD's Megatron split), on
VLA_TINY in fp32 with the random draws of the JAX key replayed.

- B1/B2 on local heads: each model rank's `mha_flash` on its (batch, head)
  block equals JAX's flash_attention (interpreted) on a data=4 x model=2
  mesh, values and q/k/v gradients (test_flash_attention_tp.py's tolerance);
- the TMA step at tp 2 and dp 2 x tp 2, with and without shard_projector;
  UADA (remat on) and UPA at tp 2, with the val and clean-filter steps: JAX's
  tolerance of its own TP test (loss 1e-4, patch rtol 2e-4 / atol 2e-5,
  metrics rtol 1e-4), and the one process's at rtol 1e-5 / atol 1e-6 (f32
  sums over other splits of the rows and the vocab);
- a GQA config (num_kv_heads 2, one KV head a rank) and a Phi-2 VLA's loss
  and pixel gradient at tp 2 against one process;
- the collectives of an inner step: one patch and one packed-sums
  all-reduce on the data group; on the model group activation-shaped sums
  (4 a layer, 5 with remat), the embed's and lm_head's [B, S_text, D], the
  projector's under shard_projector, [.., B, S_text - 1] row statistics and
  one [B, S_text - 1, 2] argmax gather an argmax; nothing weight- or
  logits-row-sized;
- the vocab-parallel reductions against whole rows, and the row-parallel
  sum and copy_to_model's gradient sum in bf16, on two threaded ranks;
- make_mesh's layout and errors, the leaf-by-leaf cut against JAX's
  `vla_param_specs`, and the refusals of a whole tree on a rank;
- parallel/evidence.py's audit (meta tensors, a fake process group) of
  every step case on every rank: the collectives the gloo rank recorded."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from roboticattack_tpu.attacks import engine as je
from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.ops.attention import causal_bias as jcausal_bias
from roboticattack_tpu.ops.attention import padding_bias as jpadding_bias
from roboticattack_tpu.ops.flash_attention import flash_attention as jflash_attention
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.parallel import replicate as jreplicate
from roboticattack_tpu.parallel import shard_batch as jshard_batch
from roboticattack_tpu.parallel.sharding import shard_params as jshard_params
from roboticattack_tpu.utils.labels import build_tma_target_tokens
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.attacks import engine as te
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY, PhiConfig
from roboticattack_torch.models.param_tree import tree_leaves
from roboticattack_torch.models.vlm import init_vla_params, vla_forward
from roboticattack_torch.ops.flash_attention import mha_flash
from roboticattack_torch.parallel import DataMesh, make_mesh, shard_leaves, shard_params
from roboticattack_torch.parallel import sharding as tsharding
from roboticattack_torch.parallel import tensor_parallel as tpar
from test_torch_attack_step import PATCH_HW, _replay_step, _torch_state
from test_torch_patch_ops import replay_patch_draws
from torch_ddp_workers import start_ranks, wait_ranks
from torch_tp_workers import tp_attack_rank

RTOL, ATOL = 1e-5, 1e-6  # against the port's one process
J_LOSS, J_RTOL, J_ATOL = 1e-4, 2e-4, 2e-5  # JAX's TP test (test_data_parallel.py)
ALL = [0, 1, 2, 3, 4, 5, 6]
LR = 2e-3
B = 4
LAYOUTS = [(2, 1), (2, 2)]  # (tp, dp)
REMAT = dataclasses.replace(VLA_TINY, remat=True)
J_REMAT = dataclasses.replace(J_TINY, remat=True)
GQA = dataclasses.replace(VLA_TINY, name="tiny-gqa", llm=dataclasses.replace(VLA_TINY.llm, num_kv_heads=2))
PHI = dataclasses.replace(VLA_TINY, name="tiny-phi", llm=PhiConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_seq_len=64))
TMA = dict(objective="tma", inner_loop=2, geometry=True)
# name -> (layout, shard_projector, spec, maskidx, torch cfg, JAX cfg or None, params, val)
STEPS = {
    "tma_tp2_sp": ((2, 1), True, TMA, ALL, VLA_TINY, J_TINY, "params", True),
    "tma_tp2": ((2, 1), False, TMA, ALL, VLA_TINY, J_TINY, "params", False),
    "tma_dp2tp2_sp": ((2, 2), True, TMA, ALL, VLA_TINY, J_TINY, "params", False),
    "tma_dp2tp2": ((2, 2), False, TMA, ALL, VLA_TINY, J_TINY, "params", True),
    "uada_tp2_remat": ((2, 1), False, dict(objective="uada", inner_loop=2), ALL, REMAT, J_REMAT, "params", True),
    "upa_tp2_sp": ((2, 1), True, dict(objective="upa", inner_loop=2, grad_clip_l1=1e-3), ALL, VLA_TINY, J_TINY,
                   "params", True),
    "tma6_tp2": ((2, 1), False, TMA, [6], VLA_TINY, None, "params", True),
    "gqa_tp2": ((2, 1), True, dict(objective="uada", inner_loop=2), ALL, GQA, None, "gqa_params", False),
}
JAX_STEPS = [name for name, c in STEPS.items() if c[5] is not None]


def _target(spec, maskidx):
    return build_tma_target_tokens(np.zeros(7), maskidx) if spec["objective"] == "tma" else None


def _phi_inputs():
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 120, (B, 10))
    mask = np.ones((B, 10), np.int64)
    mask[1, 8:] = 0
    labels = np.where(rng.random((B, 10)) < 0.6, ids, -100)
    labels[:, 0] = -100
    pixels = rng.standard_normal((B, 2, 56, 56, 3)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (ids, mask, pixels, labels))


def _jax_val_draws(rng, batch):
    _, k_patch, _ = jax.random.split(rng, 3)
    b, h, w, _ = batch.images.shape
    return te.StepDraws(inner=[replay_patch_draws(k_patch, b, h, w, *PATCH_HW)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both layouts' spawned ranks, and meanwhile the port's one process
    and JAX's mesh steps on the same weights, batch and draws."""
    tmp = tmp_path_factory.mktemp("tp_attack")
    torch.set_num_threads(1)
    jparams = jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))
    weights = {"params": params_from_jax(jparams),
               "gqa_params": init_vla_params(torch.Generator().manual_seed(1), GQA, device="cpu"),
               "phi_params": init_vla_params(torch.Generator().manual_seed(2), PHI, device="cpu")}
    batch = next(jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=1), batch_size=B, pad_to=48))
    jstate = jax.device_get(je.init_attack_state(jax.random.key(2), PATCH_HW))
    rng, vrng = jax.random.key(11), jax.random.key(29)
    cases = {}
    for name, (layout, sp, spec, maskidx, cfg, _, params, val) in STEPS.items():
        cases[name] = dict(kind="step", layout=layout, shard_projector=sp, spec=spec, maskidx=maskidx,
                           target=_target(spec, maskidx), cfg=cfg, params=params, lr=LR,
                           draws=_replay_step(rng, te.AttackSpec(**spec), batch),
                           val_draws=_jax_val_draws(vrng, batch) if val else None)
    phi_inputs = _phi_inputs()
    cases["phi_tp2"] = dict(kind="forward", layout=(2, 1), shard_projector=True, cfg=PHI, params="phi_params",
                            inputs=phi_inputs)
    payload = str(tmp / "payload.pt")
    torch.save({**weights, "batch": batch, "state": _torch_state(jstate), "cases": cases}, payload)
    ctxs = [start_ranks(tp_attack_rank, tp * dp, tp * dp, tp, dp, f"file://{tmp / f'store{tp}{dp}'}", payload,
                        str(tmp)) for tp, dp in LAYOUTS]

    single, jax_out = {}, {}
    tbatch = te.batch_to_device(batch, "cpu")
    for name, c in cases.items():
        if c["kind"] == "forward":
            px = c["inputs"][2].clone().requires_grad_()
            fwd = vla_forward(weights[c["params"]], PHI, c["inputs"][0], c["inputs"][1], px, c["inputs"][3])
            fwd.loss.backward()
            single[name] = {"loss": fwd.loss.detach(), "logits": fwd.logits.detach(), "grad": px.grad}
            continue
        spec = te.AttackSpec(**c["spec"])
        step = te.make_attack_step(spec, c["cfg"], c["target"], c["maskidx"])
        st, m = step(weights[c["params"]], _torch_state(jstate), tbatch, LR, True, c["draws"])
        single[name] = {"state": st, "metrics": m}
        if c["val_draws"] is not None:
            val = te.make_val_step(spec, c["cfg"], c["target"], c["maskidx"])
            single[name]["val"] = val(weights[c["params"]], _torch_state(jstate).patch, tbatch, c["val_draws"])
            single[name]["clean"] = te.make_clean_filter_step(c["cfg"])(weights[c["params"]], tbatch)
    for name in JAX_STEPS:
        layout, sp, spec, maskidx, _, jcfg, _, val = STEPS[name]
        tp, dp = layout
        mesh = jmake_mesh(data=dp, model=tp, devices=jax.devices()[:tp * dp])
        jp = jshard_params(jax.tree.map(jnp.asarray, jparams), mesh, shard_projector=sp)
        jb = jshard_batch(batch, mesh)
        jspec = je.AttackSpec(**spec)
        jst, jm = je.make_attack_step(jspec, jcfg, _target(spec, maskidx), maskidx)(
            jp, jreplicate(jax.tree.map(jnp.asarray, jstate), mesh), jb, jnp.float32(LR), jnp.bool_(True), rng)
        jax_out[name] = {"patch": np.asarray(jst.patch), "metrics": {k: np.asarray(v) for k, v in jm.items()}}
        if val:
            jval = je.make_val_step(jspec, jcfg, _target(spec, maskidx), maskidx)
            jax_out[name]["val"] = {k: np.asarray(v) for k, v in jval(jp, jnp.asarray(jstate.patch), jb,
                                                                     vrng).items()}
    for ctx in ctxs:
        wait_ranks(ctx)
    ranks = {layout: [torch.load(tmp / f"tp_attack_tp{layout[0]}_dp{layout[1]}_rank{r}.pt", weights_only=False)
                      for r in range(layout[0] * layout[1])] for layout in LAYOUTS}
    return ranks, single, jax_out, jstate


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def _ranks_of(runs, name):
    ranks = runs[0]
    layout = STEPS[name][0] if name in STEPS else (2, 1)
    return [r[name] for r in ranks[layout]]


def test_mesh_layout_is_jax_device_order(runs):
    """rank = d * tp + m: the model group is replica d's tp ranks, the data
    group the ranks with the same m (JAX's reshape(data, model))."""
    ranks = runs[0]
    for (tp, dp), outs in ranks.items():
        for r, out in enumerate(outs):
            d, m = divmod(r, tp)
            assert out["place"] == {"d": d, "m": m, "dp": dp, "tp": tp,
                                    "model_group": tuple(d * tp + i for i in range(tp)),
                                    "data_group": tuple(i * tp + m for i in range(dp))}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_under_a_model_axis_equals_one_process(runs, name):
    _, single, _, _ = runs
    outs = _ranks_of(runs, name)
    want = single[name]
    patch = outs[0]["state"].patch.numpy()
    for r, out in enumerate(outs):  # every rank of the grid holds the one patch
        assert np.array_equal(out["state"].patch.numpy(), patch), f"rank {r}"
        assert all(torch.equal(out["metrics"][k], outs[0]["metrics"][k]) for k in out["metrics"])
    assert sorted(outs[0]["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        assert outs[0]["metrics"][k].shape == (2,)
        close(outs[0]["metrics"][k], v, f"{name} {k}")
    close(patch, want["state"].patch, f"{name} patch")
    close(outs[0]["state"].opt.m, want["state"].opt.m, f"{name} adam m", atol=1e-9)
    assert not np.array_equal(patch, _torch_state(runs[3]).patch.numpy())


@pytest.mark.parametrize("name", JAX_STEPS)
def test_step_under_a_model_axis_equals_jax_mesh_step(runs, name):
    _, _, jax_out, _ = runs
    out = _ranks_of(runs, name)[0]
    want = jax_out[name]
    assert sorted(out["metrics"]) == sorted(want["metrics"])
    got_loss, want_loss = out["metrics"]["loss"].numpy(), want["metrics"]["loss"]
    assert np.abs(got_loss - want_loss).max() < J_LOSS, (got_loss, want_loss)
    for k, v in want["metrics"].items():
        close(out["metrics"][k], v, f"{name} {k} vs jax", rtol=1e-4, atol=1e-6)
    close(out["state"].patch, want["patch"], f"{name} patch vs jax", rtol=J_RTOL, atol=J_ATOL)


@pytest.mark.parametrize("name", [n for n, c in STEPS.items() if c[7]])
def test_val_and_clean_steps_under_a_model_axis(runs, name):
    """Every rank holds what one process computes on the whole batch: the
    scalars from the reduced sums, the per-example entries gathered over the
    data group, the patched images its replica's rows; and what JAX's mesh
    val step computes on the same draws, where the case has it."""
    _, single, jax_out, _ = runs
    layout = STEPS[name][0]
    tp, dp = layout
    want = single[name]["val"]
    for r, out in enumerate(_ranks_of(runs, name)):
        rows = slice((r // tp) * B // dp, (r // tp + 1) * B // dp)
        assert sorted(out["val"]) == sorted(want)
        for k, v in want.items():
            if k == "_patched_images":
                close(out["val"][k], v[rows], f"{name} rank {r} {k}")
            else:
                assert out["val"][k].shape == v.shape and out["val"][k].dtype == v.dtype, k
                close(out["val"][k], v, f"{name} rank {r} val {k}")
        assert torch.equal(out["clean"], single[name]["clean"])
    if name in jax_out:  # and JAX's mesh val step on the same draws (its key's)
        jwant = jax_out[name]["val"]
        got = _ranks_of(runs, name)[0]["val"]
        for k in jwant:
            if k in ("clean_gripper_correct", "_patched_images"):
                continue
            close(got[k], jwant[k], f"{name} val {k} vs jax mesh", rtol=1e-4, atol=1e-6)


def test_phi_vla_under_a_model_axis_equals_one_process(runs):
    """The Phi-2 decoder (q/k/v/fc1 column-, o/fc2 row-parallel with their
    biases after the sum, a vocab-split biased lm_head) and a sharded
    projector: the CE and the pixel gradient equal one process's."""
    _, single, _, _ = runs
    want = single["phi_tp2"]
    for r, out in enumerate(_ranks_of(runs, "phi_tp2")):
        close(out["loss"], want["loss"], f"phi rank {r} loss")
        close(out["grad"], want["grad"], f"phi rank {r} pixel grad", atol=1e-9)
        close(out["logits"], want["logits"][..., r * 64:(r + 1) * 64], f"phi rank {r} logits slice")


def _inventory(name, log, tp, dp, cfg):
    """Rank 0's collectives by kind; asserts each is one the design makes,
    none moves a logits row ([.., V/tp] or [.., V])."""
    b, d, vl = B // dp, cfg.llm.hidden_size, cfg.llm.vocab_size // tp
    model, data = tuple(range(tp)), tuple(i * tp for i in range(dp))
    kinds = {}
    for coll, op, ranks, shape, *_ in log:
        assert vl not in shape and cfg.llm.vocab_size not in shape, (name, coll, shape)
        if ranks == data and coll == "all_reduce" and op == "SUM":
            kind = "patch" if shape == (*PATCH_HW, 3) else "packed" if len(shape) == 1 else None
        elif ranks == model and coll == "all_reduce" and shape[-2:] == (b, 47):
            kind = f"rows {op}"
        elif ranks == model and coll == "all_reduce" and len(shape) == 3 and shape[0] == b and op == "SUM":
            kind = {d: f"activation {shape[1]}", cfg.vision_dim: f"features {shape[1]}"}.get(shape[2])
        elif ranks == model and coll == "all_gather" and shape == (b, 47, 2):
            kind = "argmax pairs"
        else:
            kind = None
        assert kind is not None, (name, coll, op, ranks, shape)
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


@pytest.mark.parametrize("name", ["tma_tp2_sp", "tma_dp2tp2", "uada_tp2_remat"])
def test_collectives_of_an_inner_step(runs, name):
    """Per inner step: one patch and one packed-sums all-reduce on the data
    group; on the model group 4 activation sums a layer (o and down forward,
    the two copies' input gradients), 5 with remat (the re-forward runs o's
    sum again and stops after down's product, the last value the backward
    needs: non-reentrant checkpointing's early stop), the embed lookup's and
    lm_head's input gradient, the
    projector's fc2 sum (and re-forward) and fc1's input gradient under
    shard_projector, a MAX and a SUM of row statistics per log-softmax or
    expectation, one gather of (max, id) pairs per argmax."""
    layout, sp, spec, _, cfg, *_ = STEPS[name]
    tp, dp = layout
    n = spec["inner_loop"]
    per_layer = 5 if cfg.remat else 4
    reductions = 1 if spec["objective"] == "tma" else 2
    want = {"patch": n, "packed": n, f"activation {48 + cfg.num_patches}": n * per_layer * cfg.llm.num_layers,
            "activation 48": n * 2, "rows MAX": n * reductions, "rows SUM": n * reductions, "argmax pairs": n}
    if sp:
        want[f"activation {cfg.num_patches}"] = n * (2 if cfg.remat else 1)
        want[f"features {cfg.num_patches}"] = n
    assert _inventory(name, _ranks_of(runs, name)[0]["collectives"], tp, dp, cfg) == want


@pytest.mark.parametrize("name", list(STEPS))
def test_audit_inventory_equals_the_ranks_collectives(runs, name):
    """parallel/evidence.py's audit of each rank's step, on meta under a
    fake process group of the layout, issues the collectives the gloo rank
    recorded (as a multiset of name, op, group ranks, shape and dtype), on
    every rank of tp 2 and dp 2 x tp 2: the audit that vouches for the 7B
    layout runs the same code as the ranks do."""
    from roboticattack_torch.parallel.evidence import audit_attack_step, inventory

    (tp, dp), sp, spec, maskidx, cfg, *_ = STEPS[name]
    for r, out in enumerate(_ranks_of(runs, name)):
        audit = audit_attack_step(cfg, dp, tp, r, batch_size=B, pad_to=48, objective=spec["objective"],
                                  inner_loop=spec["inner_loop"], shard_projector=sp, maskidx=maskidx,
                                  patch_hw=PATCH_HW)
        assert inventory(audit.collectives) == inventory(out["collectives"]), (name, r)
        assert not torch.distributed.is_initialized()


def test_flash_on_local_heads_equals_jax_under_a_model_axis():
    """B1/B2 per (batch, head) block: each of a data=4 x model=2 grid's
    ranks runs mha_flash on its [B/4, H/2, S, D] block, with no gather; the
    blocks put together equal JAX's flash_attention on that mesh, values
    and q/k/v gradients (rtol/atol 3e-5, test_flash_attention_tp.py's)."""
    rng = np.random.default_rng(1)
    b, h, s, d = 4, 4, 48, 16
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[b - 1, s - 7:] = 0
    bias4 = np.asarray(jcausal_bias(s, s) + jpadding_bias(jnp.asarray(mask)))  # [B, 1, S, S]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    qkv_s, b_s = NamedSharding(mesh, JP("data", "model", None, None)), NamedSharding(mesh, JP("data", None, None))
    args = [jax.device_put(jnp.asarray(x), qkv_s) for x in (q, k, v)] + [jax.device_put(jnp.asarray(bias4[:, 0]), b_s)]
    f = jax.jit(lambda q, k, v, bb: jflash_attention(q, k, v, bb, True))
    want = np.asarray(f(*args))
    want_grads = jax.jit(jax.grad(lambda q, k, v, bb: jnp.sum(jflash_attention(q, k, v, bb, True) * g),
                                  argnums=(0, 1, 2)))(*args)
    got = np.zeros_like(want)
    grads = [np.zeros_like(q) for _ in range(3)]
    for dd in range(4):
        for m in range(2):
            rows, heads = slice(dd, dd + 1), slice(2 * m, 2 * m + 2)
            local = [torch.from_numpy(x[rows, heads].copy()).requires_grad_() for x in (q, k, v)]
            out = mha_flash(*local, bias=torch.from_numpy(bias4[rows].copy()))
            (out * torch.from_numpy(g[rows, heads])).sum().backward()
            got[rows, heads] = out.detach().numpy()
            for i, t in enumerate(local):
                grads[i][rows, heads] = t.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    for mine, theirs in zip(grads, want_grads):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=3e-5, atol=3e-5)


def test_make_mesh_refuses_a_world_that_is_not_data_by_model(monkeypatch):
    """No NotImplementedError any more: a world of one is not 1 x 2, and a
    world of 4 is not 3 x 2; both raise ValueError before joining a
    process group."""
    for var in ("MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="data x model"):
        make_mesh(model=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="needs a world of data x model"):
        make_mesh(data=3, model=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(data=2, model=0, device="cpu")
    assert not torch.distributed.is_initialized()


def _fake_mesh(tp, m=0):
    return DataMesh(group=None, rank=0, size=1, device=torch.device("cpu"), model_group=None, m=m, tp=tp)


def test_heads_that_do_not_split_and_a_whole_tree_on_a_rank_raise():
    from roboticattack_torch.models.llama import local_heads

    assert local_heads(GQA.llm, _fake_mesh(2)) == (2, 1)
    with pytest.raises(ValueError, match="num_heads = 4 does not split over a model axis of 3"):
        local_heads(VLA_TINY.llm, _fake_mesh(3))
    with pytest.raises(ValueError, match="num_kv_heads = 2 does not split over a model axis of 4"):
        local_heads(GQA.llm, _fake_mesh(4))
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="cut them with parallel.shard_params"):
        vla_forward(params, VLA_TINY, ids, torch.ones_like(ids), None, mesh=_fake_mesh(2))
    local = shard_params(params, _fake_mesh(2))
    with pytest.raises(ValueError, match="cut them with parallel.shard_params"):
        vla_forward(local, VLA_TINY, ids, torch.ones_like(ids), None)


@pytest.mark.parametrize("shard_projector", [False, True])
def test_leaf_by_leaf_cut_follows_jax_specs(shard_projector):
    """shard_leaves cuts each leaf by its own spec as it arrives: every
    leaf's spec equals JAX's vla_param_specs on a tree of the same paths and
    ranks (Llama, GQA and Phi-2 decoders), each rank's slices put together
    give the tree back, and a cut leaf is a copy, not a view that keeps the
    whole leaf alive."""
    from roboticattack_tpu.parallel.sharding import vla_param_specs as jvla_param_specs

    for cfg, seed in ((VLA_TINY, 0), (GQA, 1), (PHI, 2)):
        params = init_vla_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        jtree = {}
        for path, x in tree_leaves(params):
            node = jtree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.zeros((1,) * x.dim(), np.float32)
        want = {tuple(k.key for k in p): tuple(spec) for p, spec in jax.tree_util.tree_flatten_with_path(
            jvla_param_specs(jtree, shard_projector=shard_projector), is_leaf=lambda x: isinstance(x, JP))[0]}
        parts = [dict(shard_leaves(tree_leaves(params), _fake_mesh(2, m), shard_projector=shard_projector))
                 for m in range(2)]
        for path, x in tree_leaves(params):
            spec = tsharding.vla_leaf_spec(path, x, shard_projector=shard_projector)
            assert tuple(spec) == want[path], path
            dim = tsharding.split_dim(spec)
            whole = x if dim is None else torch.cat([p[path] for p in parts], dim=dim)
            assert torch.equal(whole, x), path
            if dim is not None:
                assert parts[0][path].untyped_storage().nbytes() < x.untyped_storage().nbytes(), path


def test_vocab_parallel_reductions_equal_whole_rows():
    """The objectives' reductions over two vocab slices equal the whole
    rows' in one process: the log-softmax at ids on either slice, the
    argmax over the row and over ranges inside one slice or straddling
    both, the softmax expectation over a straddling range; two threads
    stand for the two ranks of a model group."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((2, 5, 40)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (2, 5)))
    weights = torch.arange(1, 13, dtype=torch.float32)
    halves = [z[..., :20], z[..., 20:]]
    assert torch.equal(tpar.vocab_argmax(z), z.argmax(-1))
    assert torch.equal(tpar.vocab_argmax(z, None, 14, 26), z[..., 14:26].argmax(-1) + 14)
    want = tpar.vocab_token_logprob(z, idx)
    for got in _run_pair(lambda zz, mesh: tpar.vocab_token_logprob(zz, idx, mesh), halves):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = tpar.vocab_expectation(z, 14, 26, weights)
    for got in _run_pair(lambda zz, mesh: tpar.vocab_expectation(zz, 14, 26, weights, mesh), halves):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for lo, hi in ((0, None), (14, 26), (22, 30), (3, 9)):
        want = tpar.vocab_argmax(z, None, lo, hi)
        for got in _run_pair(lambda zz, mesh: tpar.vocab_argmax(zz, mesh, lo, hi), halves):
            assert torch.equal(got, want), (lo, hi)


def test_row_parallel_sum_adds_the_partial_products_in_the_model_dtype():
    """A row-parallel product in bf16 over two ranks (threads), as the
    decoder's o/down and the projector's fc2 make it: each rank's partial
    product in bf16, the two summed in bf16 (the convention of the serving
    decode and of JAX's GSPMD program), within two bf16 ulps of one
    process's product; the input gradient is each rank's slice of one
    process's, bit for bit, and copy_to_model's backward sums the ranks'
    input gradients in bf16."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32) * 0.1).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((3, 5, 48)).astype(np.float32)).to(torch.bfloat16)
    xw = x.clone().requires_grad_()
    want = xw @ w
    want.backward(g)
    grads = [None, None]

    def rank(xs, mesh):
        xs = xs.clone().requires_grad_()
        out = tpar.reduce_from_model(xs @ w[mesh.m * 32:(mesh.m + 1) * 32], mesh)
        out.backward(g)
        grads[mesh.m] = xs.grad
        return out

    outs = _run_pair(rank, [x[..., :32], x[..., 32:]])
    p0, p1 = x[..., :32] @ w[:32], x[..., 32:] @ w[32:]
    for out in outs:
        assert out.dtype == torch.bfloat16 and torch.equal(out, p0 + p1)
        assert _within_roundings(out, want.detach(), p0, p1)
    assert torch.equal(torch.cat(grads, dim=-1), xw.grad)

    h = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32)).to(torch.bfloat16)
    wc = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32) * 0.1).to(torch.bfloat16)
    hw = h.clone().requires_grad_()
    (hw @ wc).backward(g)
    got = [None, None]

    def column(hs, mesh):
        hs = hs.clone().requires_grad_()
        cols = slice(mesh.m * 24, (mesh.m + 1) * 24)
        (tpar.copy_to_model(hs, mesh) @ wc[:, cols]).backward(g[..., cols])
        got[mesh.m] = hs.grad
        return hs.grad

    _run_pair(column, [h, h])
    p0, p1 = g[..., :24] @ wc[:, :24].T, g[..., 24:] @ wc[:, 24:].T
    for r in range(2):
        assert got[r].dtype == torch.bfloat16 and torch.equal(got[r], p0 + p1)
    assert _within_roundings(got[0], hw.grad, p0, p1)


def _within_roundings(got, want, p0, p1) -> bool:
    """|got - want| within the bf16 roundings that separate a sum of two
    rounded partial products from one process's rounded product: half an
    ulp of each partial, of their sum and of the product, bounded by eps x
    (|p0| + |p1| + |want|)."""
    eps = torch.finfo(torch.bfloat16).eps
    bound = eps * (p0.float().abs() + p1.float().abs() + want.float().abs())
    return bool(((got.float() - want.float()).abs() <= bound).all())


def _run_pair(fn, halves):
    """fn(slice, mesh) on two threads standing for the two ranks of a model
    group, their collectives joined through a barrier: the results of
    both."""
    import threading

    import torch.distributed as dist

    barrier, box, out = threading.Barrier(2), [None, None], [None, None]

    def collective(rank):
        def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
            box[rank] = t.clone()
            barrier.wait()
            other = box[1 - rank]
            res = torch.maximum(t, other) if op == dist.ReduceOp.MAX else (box[0] + box[1])
            barrier.wait()
            t.copy_(res)

        def all_gather(parts, t, group=None):
            box[rank] = t.clone()
            barrier.wait()
            parts[0].copy_(box[0])
            parts[1].copy_(box[1])
            barrier.wait()

        return all_reduce, all_gather

    local = threading.local()

    def dispatch(name):
        return lambda *a, **k: getattr(local, name)(*a, **k)

    saved = dist.all_reduce, dist.all_gather
    dist.all_reduce, dist.all_gather = dispatch("all_reduce"), dispatch("all_gather")

    def run(rank):
        local.all_reduce, local.all_gather = collective(rank)
        out[rank] = fn(halves[rank], _fake_mesh(2, rank)).detach()

    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        dist.all_reduce, dist.all_gather = saved
    return out


def test_runner_under_a_model_axis_replicates_the_weights_as_jax(tmp_path):
    """JAX's OpenVLAAttacker replicates the weights on a (data, model) mesh;
    the port's runner takes the mesh's data axis alone, so each rank of a
    model group runs its replica's step on the whole tree (no JAX CLI takes
    a model axis, and the port's adds none)."""
    from roboticattack_torch.attacks.attacker import AttackConfig, OpenVLAAttacker

    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu")
    mesh = DataMesh(group="data", rank=1, size=2, device=torch.device("cpu"), model_group="model", m=1, tp=2)
    runner = OpenVLAAttacker(params, VLA_TINY, str(tmp_path), AttackConfig(objective="uada"), mesh=mesh)
    assert runner.mesh == DataMesh(group="data", rank=1, size=2, device=torch.device("cpu"))
    assert runner.params is params
