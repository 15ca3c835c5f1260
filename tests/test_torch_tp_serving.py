"""The port's tensor- and data-parallel serving on the CPU over gloo: two
ranks at tp=2 and four at dp=2 x tp=2, spawned once for the module
(tests/torch_tp_workers.py), against the port's one process and the JAX
package's mesh decode on VLA_TINY (fp32).

- specs and group sizes equal JAX's; the ranks' slices, loaded leaf by
  leaf, put back together equal the single-process tree;
- the decode (fp32, int8, w8a8, int4 at the tp=2 group size 32, int8 and
  int4 KV caches, visual tokens, a Jacobi draft): tokens and actions equal
  one process's and JAX's, logits within rtol 1e-5 / atol 1e-6 of one
  process's (the row-parallel sums run in another order), w8a8's prefill
  logits bit-equal to one process's, verify passes equal JAX's;
- the traffic of a decode: two sums a layer over the tensor-parallel group,
  one logits gather a token, one MAX over the world a Jacobi pass, the w8a8
  prefill's two absmax MAX a layer, nothing else;
- parallel/evidence.py's audit (meta tensors, a fake process group) of
  the fp32, int4, w8a8 and Jacobi decodes on every rank: the collectives
  the gloo rank recorded;
- the errors of JAX's decode, raised from the sizes without any process;
- VLAPolicy(mesh=...) and the rank-0 front end: a batch dp divides and one
  it does not (served replicated, one warning) equal one process's actions;
  `cli.serve --dp 2 --tp 2` answers two HTTP clients with one process's
  actions and every rank exits after rank 0 stops; `cli.eval_libero --tp 2`
  gives the single-process summary and log."""

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
from jax.sharding import NamedSharding, PartitionSpec as JP

import chip_smoke
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.models.config import OPENVLA_7B as J_7B
from roboticattack_tpu.models.decode import decode_layout_params as j_cook
from roboticattack_tpu.models.decode import greedy_decode_actions as j_decode
from roboticattack_tpu.models.quant import int4_group_size_for as j_group_size
from roboticattack_tpu.models.quant import quantize_decode_params as j_quantize
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.parallel import sharding as jsharding
from roboticattack_torch.attacks.artifacts import save_patch_pt
from roboticattack_torch.eval.policy import VLAPolicy, load_policy
from roboticattack_torch.models import quant as tquant
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import OPENVLA_7B, VLA_TINY
from roboticattack_torch.models.param_tree import tree_leaves
from roboticattack_torch.models.decode import greedy_decode_actions
from roboticattack_torch.parallel import ServingMesh, make_serving_mesh
from roboticattack_torch.parallel import sharding as tsharding
from roboticattack_torch.utils.prompting import WordStubTokenizer
from test_decode import _prompt
from torch_ddp_workers import start_ranks, wait_ranks
from torch_tp_workers import STATS, quantized_tree, serving_rank

RTOL, ATOL = 1e-5, 1e-6
KV_TAIL_ATOL = 1e-4  # the quantized caches' tail logits (see the decode test)
LAYOUTS = [(2, 1), (2, 2)]  # (tp, dp)
GS_TP2 = 32  # int4_group_size_for(VLA_TINY, tp=2)
B = 4
REAL_STEPS = 3
CASES = {  # name -> (weights, group size, decode options)
    "fp32": (None, None, {}),
    "int8": ("int8", None, {}),
    "w8a8": ("int8", None, {"act_quant": "int8"}),
    "int4": ("int4", GS_TP2, {}),
    "kv8": (None, None, {"kv_cache": "int8"}),
    "kv4": (None, None, {"kv_cache": "int4"}),
    "vt8": (None, None, {"visual_tokens": 8}),
    "jacobi": (None, None, {"draft_tokens": None}),  # a draft right at positions 1-3
}
JAX_TP2 = ("fp32", "int4", "jacobi")  # also against JAX's tp=2 mesh (all against dp2 x tp2)


def _j_tree(cooked, quant, gs):
    return cooked if quant is None else j_quantize(cooked, xp=np, mode=quant, group_size=gs or 64)


def _jax_mesh_decode(tree, inputs, data, model, draft=None, **kw):
    mesh = jmake_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    p = jsharding.shard_decode_params(jax.tree.map(jnp.asarray, tree), mesh)
    bsh = NamedSharding(mesh, JP("data"))
    fn = jax.jit(lambda p, i, m, x, d: j_decode(p, J_TINY, i, m, x, cooked_weights=True, mesh=mesh,
                                                 draft_tokens=d, **kw))
    return fn(p, *(jax.device_put(jnp.asarray(x), bsh) for x in inputs),
              None if draft is None else jax.device_put(jnp.asarray(draft), bsh))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every check's rank outputs from both layouts' spawns, and meanwhile
    the port's one process and JAX's mesh decodes."""
    tmp = tmp_path_factory.mktemp("tp_serving")
    torch.set_num_threads(1)
    jparams = jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))
    params = params_from_jax(jparams)
    ids, mask, px = _prompt(batch=B, seed=1)
    inputs = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(np.asarray(px)))
    # the Jacobi draft: one process's tokens, wrong from position 4 on
    seq = greedy_decode_actions(quantized_tree(params, None, None), VLA_TINY, *inputs, cooked_weights=True)
    draft = seq.tokens.clone()
    draft[:, 4:] = 0
    cases = {name: {"quant": q, "gs": gs,
                    "kw": dict(kw, draft_tokens=draft) if "draft_tokens" in kw else dict(kw)}
             for name, (q, gs, kw) in CASES.items()}
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (B, 56, 56, 3), dtype=np.uint8)
    tasks = [f"stack the cups {i}" for i in range(B)]
    patch = str(tmp / "patch.pt")
    save_patch_pt(np.random.default_rng(6).uniform(0, 1, (20, 20, 3)).astype(np.float32), patch)
    episodes = [chip_smoke.coherent_walk(np.random.default_rng(s), 24) for s in (45, 46)]
    eval_argv = ["--model", "vla-tiny", "--device", "cpu", "--patchroot", patch, "--x", "120", "--y", "160",
                 "--batch_trials", "2", "--num_trials_per_task", "2", "--jacobi", "true"]
    payload = str(tmp / "payload.pt")
    torch.save({"params": params, "inputs": inputs, "cases": cases, "frames": frames, "tasks": tasks,
                "policy_quants": [None, "int4"], "episodes": episodes, "real_steps": REAL_STEPS,
                "eval_argv": eval_argv + ["--tp", "2"],
                "serve_argv": ["--model", "vla-tiny", "--device", "cpu", "--port", "0", "--max_batch", "2",
                               "--max_wait_ms", "200", "--dp", "2", "--tp", "2"]}, payload)
    ctxs = [start_ranks(serving_rank, tp * dp, tp * dp, tp, dp, f"file://{tmp / f'store{tp}{dp}'}", payload,
                        str(tmp)) for tp, dp in LAYOUTS]

    single = {}
    for name, c in cases.items():
        single[name] = greedy_decode_actions(quantized_tree(params, c["quant"], c["gs"]), VLA_TINY, *inputs,
                                             cooked_weights=True, **c["kw"])
    jcooked = j_cook(jparams, xp=np)
    jax_out = {}
    for name, c in cases.items():
        kw = {k: v for k, v in c["kw"].items() if k != "draft_tokens"}
        d = c["kw"].get("draft_tokens")
        d = None if d is None else d.numpy()
        tree = _j_tree(jcooked, c["quant"], c["gs"])
        for tp, dp in LAYOUTS:  # keyed (name, tp, dp)
            if dp == 2 or name in JAX_TP2:
                jax_out[(name, tp, dp)] = _jax_mesh_decode(tree, (ids, mask, px), dp, tp, d, **kw)
    policies = {q: VLAPolicy(params, VLA_TINY, WordStubTokenizer(), STATS, quantize=q and f"{q}:{GS_TP2}",
                             device="cpu") for q in (None, "int4")}
    policy_single = {q: {"odd": pol.get_action_multi(frames[:3], tasks[:3]),
                         "even": pol.get_action_multi(frames, tasks),
                         "tree": pol.model.tree()} for q, pol in policies.items()}
    # cli.serve's own weights: load_policy's seeded draw
    served_single = load_policy(None, "vla-tiny", device="cpu").get_action_multi(frames[:2], tasks[:2])
    eval_single = _eval_single(eval_argv, episodes, tmp / "eval_single")
    for ctx in ctxs:
        wait_ranks(ctx, timeout=240)
    ranks = {(tp, dp): [torch.load(tmp / f"tp{tp}_dp{dp}_rank{r}.pt", weights_only=False)
                        for r in range(tp * dp)] for tp, dp in LAYOUTS}
    return {"ranks": ranks, "single": single, "jax": jax_out, "cases": cases, "params": params,
            "policy_single": policy_single, "served_single": served_single, "eval_single": eval_single,
            "tmp": tmp}


def _eval_single(argv, episodes, out):
    from roboticattack_torch.cli import eval_libero

    buf = io.StringIO()
    with chip_smoke.ReplayLibero(episodes, REAL_STEPS), contextlib.redirect_stdout(buf):
        eval_libero.main(argv + ["--output", str(out)])
    return buf.getvalue(), {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}


def _gathered(ranks, tp, dp, name):
    """The whole batch's result from the first model rank of each replica."""
    parts = [ranks[d * tp]["decode"][name]["result"] for d in range(dp)]
    tokens = torch.cat([r.tokens for r in parts])
    actions = torch.cat([r.actions for r in parts])
    logits = None if parts[0].logits is None else torch.cat([r.logits for r in parts])
    return tokens, actions, logits, [r.verify_passes for r in parts]


# ------------------------------------------------------------------ specs


def _spec_trees(params, jparams_np):
    tcooked = quantized_tree(params, None, None)
    jcooked = j_cook(jparams_np, xp=np)
    return {
        "fp": (tcooked, jcooked),
        "int8": (tquant.quantize_decode_params(tcooked, "int8"), j_quantize(jcooked, xp=np, mode="int8")),
        "int4": (tquant.quantize_decode_params(tcooked, "int4", 32),
                 j_quantize(jcooked, xp=np, mode="int4", group_size=32)),
    }




@pytest.fixture(scope="module")
def spec_trees():
    jparams = jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))
    return _spec_trees(params_from_jax(jparams), jparams)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_decode_param_specs_equal_jax(spec_trees, kind):
    ttree, jtree = spec_trees[kind]
    got = dict(tree_leaves(tsharding.decode_param_specs(ttree)))
    want = {p: s for p, s in jax.tree_util.tree_flatten_with_path(
        jsharding.decode_param_specs(jtree), is_leaf=lambda x: isinstance(x, JP))[0]}
    want = {tuple(k.key for k in p): tuple(s) for p, s in want.items()}
    assert set(got) == set(want) == {p for p, _ in tree_leaves(ttree)}
    for path, spec in got.items():
        assert tuple(spec) == want[path], path


def test_vla_param_specs_equal_jax(spec_trees):
    jparams = jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))
    tparams = params_from_jax(jparams)
    for shard_projector in (False, True):
        got = dict(tree_leaves(tsharding.vla_param_specs(tparams, shard_projector=shard_projector)))
        want = jax.tree_util.tree_flatten_with_path(
            jsharding.vla_param_specs(jparams, shard_projector=shard_projector),
            is_leaf=lambda x: isinstance(x, JP))[0]
        want = {tuple(k.key for k in p): tuple(s) for p, s in want}
        assert got.keys() == want.keys()
        assert all(tuple(got[p]) == want[p] for p in got)
    for tfn, jfn in ((tsharding.llama_param_specs, jsharding.llama_param_specs),
                     (tsharding.phi_param_specs, jsharding.phi_param_specs)):
        tf, jf = dict(tree_leaves(tfn())), {tuple(k.key for k in p): tuple(s) for p, s in
                                      jax.tree_util.tree_flatten_with_path(jfn(), is_leaf=lambda x: isinstance(x, JP))[0]}
        assert {p: tuple(s) for p, s in tf.items()} == jf
    bad = {"vision": {}, "projector": {}, "llm": {"layers": {"q_w": torch.zeros(1, 1, 1), "wq_bias": torch.zeros(1)}}}
    with pytest.raises(KeyError, match="wq_bias"):
        tsharding.vla_param_specs(bad)
    with pytest.raises(KeyError, match="wq_bias"):
        tsharding.decode_param_specs(bad)


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("which", ["tiny", "7b"])
def test_int4_group_size_for_equals_jax(which, tp):
    tcfg, jcfg = (VLA_TINY, J_TINY) if which == "tiny" else (OPENVLA_7B, J_7B)
    try:
        want = j_group_size(jcfg, tp=tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tquant.int4_group_size_for(tcfg, tp=tp)
        assert str(got.value) == str(e)
        return
    assert tquant.int4_group_size_for(tcfg, tp=tp) == want
    assert {("tiny", 1): 64, ("tiny", 2): 32, ("7b", 1): 128, ("7b", 2): 128, ("7b", 4): 64}.get((which, tp), want) == want


# ------------------------------------------------------------------ slices


@pytest.mark.parametrize("tp,dp", LAYOUTS)
@pytest.mark.parametrize("quant", [None, "int4"])
def test_rank_slices_put_together_equal_the_single_process_tree(served, tp, dp, quant):
    """The policy's leaf-by-leaf load on each rank equals its cut of the
    single-process tree quantize_decode_params(decode_layout_params(...)),
    which one process's policy holds, and the model ranks' cuts
    concatenate to it."""
    want = quantized_tree(served["params"], quant, GS_TP2)
    single = dict(tree_leaves(served["policy_single"][quant]["tree"]))
    assert single.keys() == dict(tree_leaves(want)).keys()
    assert all(torch.equal(single[p], x) and single[p].dtype == x.dtype for p, x in tree_leaves(want))
    specs = dict(tree_leaves(tsharding.decode_param_specs(want)))
    ranks = served["ranks"][(tp, dp)]
    for path, full in tree_leaves(want):
        dim = tsharding.split_dim(specs[path])
        shards = []
        for r, rk in enumerate(ranks):
            got = dict(tree_leaves(rk["policy"][f"shard_{quant}"]))[path]
            mesh = ServingMesh(tp=tp, dp=dp, rank=r, device=torch.device("cpu"))
            assert torch.equal(got, tsharding.take_shard(full, dim, mesh.m, tp)), (path, r)
            if mesh.d == 0:
                shards.append(got)
        joined = shards[0] if dim is None else torch.cat(shards, dim=dim)
        assert joined.dtype == full.dtype and torch.equal(joined, full), path


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("tp,dp", LAYOUTS, ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_equals_one_process_and_jax(served, name, tp, dp):
    tokens, actions, logits, passes = _gathered(served["ranks"][(tp, dp)], tp, dp, name)
    ref = served["single"][name]
    assert torch.equal(tokens, ref.tokens) and torch.equal(actions, ref.actions)
    for r, rk in enumerate(served["ranks"][(tp, dp)]):  # every model rank of a replica agrees
        mine = rk["decode"][name]["result"]
        n = B // dp
        assert torch.equal(mine.tokens, ref.tokens[(r // tp) * n:(r // tp + 1) * n]), r
    if ref.logits is not None and "kv_cache" in served["cases"][name]["kw"]:
        # the prefill attends the full-precision K/V; the tail reads a cache
        # that rounds each K/V row to 1/127 (1/7) of its absmax, where a
        # last-bit difference of the reordered row-parallel sums can move an
        # entry by one quantum
        np.testing.assert_allclose(logits[:, 0].numpy(), ref.logits[:, 0].numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(logits.numpy(), ref.logits.numpy(), rtol=RTOL, atol=KV_TAIL_ATOL)
    elif ref.logits is not None:
        np.testing.assert_allclose(logits.numpy(), ref.logits.numpy(), rtol=RTOL, atol=ATOL)
    else:
        assert passes == [ref.verify_passes] * dp
    for layout in {(2, 2), (tp, dp)}:
        if (name,) + layout not in served["jax"]:
            continue
        j = served["jax"][(name,) + layout]
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(j.tokens))
        np.testing.assert_allclose(actions.numpy(), np.asarray(j.actions), rtol=0, atol=1e-7)
        if j.verify_passes is not None:
            assert passes == [int(j.verify_passes)] * dp
    if name == "w8a8":  # the int32 sums are exact: the w8a8 prefill is one process's bit for bit
        assert torch.equal(logits[:, 0], ref.logits[:, 0])
    if name == "jacobi":
        assert 1 < ref.verify_passes < 6


def _traffic(name, case, tp_ranks, layers=2, steps=7, passes=None):
    """The collectives a decode of this case makes on one rank."""
    want = {("all_reduce", "SUM", tp_ranks): 2 * layers * (1 + (passes if passes is not None else steps - 1)),
            ("all_gather", None, tp_ranks): 1 + (passes if passes is not None else steps - 1)}
    if passes is not None:
        want[("all_reduce", "MAX", "world")] = passes
    if case["kw"].get("act_quant") == "int8":
        want[("all_reduce", "MAX", tp_ranks)] = 2 * layers
    return want


@pytest.mark.parametrize("tp,dp", LAYOUTS, ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("name", ["fp32", "int8", "w8a8", "int4", "jacobi"])
def test_decode_traffic(served, name, tp, dp):
    case = served["cases"][name]
    for r, rk in enumerate(served["ranks"][(tp, dp)]):
        log = rk["decode"][name]["collectives"]
        d = r // tp
        tp_ranks = tuple(range(d * tp, d * tp + tp))
        got = {}
        for n, op, group, *_ in log:
            got[(n, op, group)] = got.get((n, op, group), 0) + 1
        passes = rk["decode"][name]["result"].verify_passes
        assert got == _traffic(name, case, tp_ranks, passes=passes), (r, got)
        sums = [c for c in log if c[:3] == ("all_reduce", "SUM", tp_ranks)]
        if name == "w8a8":  # the prefill sums int32 products, the weight-only tail f32
            assert [c[4] for c in sums[:4]] == ["torch.int32"] * 4
            assert {c[4] for c in sums[4:]} == {"torch.float32"}
        else:
            assert {c[4] for c in sums} == {"torch.float32"}
        gathers = [c for c in log if c[0] == "all_gather"]
        assert all(c[3][-1] == VLA_TINY.llm.vocab_size // tp and c[4] == "torch.float32" for c in gathers)


AUDITED = {"fp32": {}, "int4": {"quantize": f"int4:{GS_TP2}"},
           "w8a8": {"quantize": "int8", "act_quant": "int8"}, "jacobi": {"jacobi": True}}


@pytest.mark.parametrize("tp,dp", LAYOUTS, ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("name", list(AUDITED))
def test_audit_inventory_equals_the_ranks_collectives(served, name, tp, dp):
    """parallel/evidence.py's audit of each rank's decode, on meta under a
    fake process group of the layout, issues the collectives the gloo rank
    recorded (as a multiset of name, op, group ranks, shape and dtype). The
    Jacobi audit runs all n - 1 passes (a meta draft has nothing to
    compare): the rank's log equals the audit's up to the end of the pass
    the rank's draft converged in."""
    from roboticattack_torch.parallel.evidence import audit_decode, inventory

    ids, _, _ = _prompt(batch=B, seed=1)
    for r, rk in enumerate(served["ranks"][(tp, dp)]):
        got = rk["decode"][name]
        audit = audit_decode(VLA_TINY, dp, tp, r, batch_size=B, prompt_pad=ids.shape[1], **AUDITED[name])
        want = audit.collectives
        if name == "jacobi":
            flags = [i for i, c in enumerate(want) if c.op == "MAX" and c.ranks == "world"]
            assert len(flags) == 6
            want = want[:flags[got["result"].verify_passes - 1] + 1]
        assert inventory(want) == inventory(got["collectives"]), (name, r)


def test_decode_errors_raise_from_the_sizes(served):
    """JAX's errors, raised on meshes that have no process behind them."""
    cooked = quantized_tree(served["params"], None, None)
    ids, mask, px = _prompt(batch=2, seed=1)
    inputs = (torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(np.asarray(px)))
    with pytest.raises(ValueError, match="divisible"):
        greedy_decode_actions(cooked, VLA_TINY, *inputs, cooked_weights=True,
                              mesh=ServingMesh(tp=8, dp=1, rank=0, device=torch.device("cpu")))
    jcooked = j_cook(jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0))), xp=np)
    with pytest.raises(ValueError, match="divisible"):
        jmesh = jmake_mesh(data=1, model=8)
        j_decode(jsharding.shard_decode_params(jax.tree.map(jnp.asarray, jcooked), jmesh), J_TINY,
                 jnp.asarray(ids), jnp.asarray(mask), px, cooked_weights=True, mesh=jmesh)
    q64 = tquant.quantize_decode_params(cooked, "int4", 64)  # tp=1's group: straddles at tp=2
    with pytest.raises(ValueError, match="not a multiple of the quantization group size"):
        greedy_decode_actions(q64, VLA_TINY, *inputs, cooked_weights=True,
                              mesh=ServingMesh(tp=2, dp=1, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="rank's shard"):
        greedy_decode_actions(tquant.quantize_decode_params(cooked, "int4", 32), VLA_TINY, *inputs,
                              cooked_weights=True, mesh=ServingMesh(tp=2, dp=1, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        make_serving_mesh(tp=2, dp=2, device="cpu")
    assert make_serving_mesh(1, 1) is None


# ------------------------------------------------------------------ policy, HTTP, CLIs


@pytest.mark.parametrize("tp,dp", LAYOUTS, ids=["tp2", "dp2xtp2"])
@pytest.mark.parametrize("quant", [None, "int4"])
def test_policy_over_ranks_equals_one_process(served, quant, tp, dp):
    ranks = served["ranks"][(tp, dp)]
    got = ranks[0]["policy"][f"actions_{quant}"]
    want = served["policy_single"][quant]
    np.testing.assert_array_equal(got["even"], want["even"])
    np.testing.assert_array_equal(got["odd"], want["odd"])
    np.testing.assert_array_equal(got["odd_again"], want["odd"])
    warned = got["stderr"].count("not divisible by the mesh's data axis")
    assert warned == (1 if dp > 1 else 0), got["stderr"]
    # the followers ran every decode rank 0 ran, on their replica's rows
    logs = [rk["policy"][f"log_{quant}"] for rk in ranks]
    rows = [3, 3, B // dp]
    assert all([e["rows"] for e in lg] == rows for lg in logs), logs
    assert all(rk["policy"][f"actions_{quant}"] is None for rk in ranks[1:])


def test_serve_cli_over_dp2_tp2(served):
    ranks = served["ranks"][(2, 2)]
    out = ranks[0]["serve"]
    want = served["served_single"]
    assert out["health"]["stats"]["requests"] == 2 and out["health"]["stats"]["errors"] == 0
    for i, reply in enumerate(out["replies"]):
        np.testing.assert_array_equal(np.asarray(reply["action"]), want[i])
    assert "rank 0 of 4 (pid" in out["stdout"]
    reports = []
    for r, rk in enumerate(ranks):
        m = re.search(rf"serving rank {r}/4: (\{{.*\}})", rk["serve"]["stdout"])
        assert m, rk["serve"]["stdout"]
        reports.append(json.loads(m.group(1)))
    assert [(x["rank"], x["tp"], x["dp"], x["backend"]) for x in reports] == [(r, 2, 2, "gloo") for r in range(4)]
    # warmup (buckets 1, 2) and the served batches: the same decodes on every rank
    assert len({x["decodes"] for x in reports}) == 1 and reports[0]["decodes"] >= 3
    assert "serving on http://" not in ranks[1]["serve"]["stdout"]


def test_eval_libero_cli_tp2_gives_the_single_process_summary(served):
    stdout_single, files_single = served["eval_single"]
    tmp = served["tmp"]
    out = tmp / "cli_2x1" / "eval"
    files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
    assert files == files_single
    ranks = served["ranks"][(2, 1)]
    assert "success rate: 2/2" in ranks[0]["eval"] and "success rate: 2/2" in stdout_single
    assert "success rate" not in ranks[1]["eval"]
    reports = [json.loads(re.search(rf"serving rank {r}/2: (\{{.*\}})", rk["eval"]).group(1))
               for r, rk in enumerate(ranks)]
    assert reports[0]["decodes"] == reports[1]["decodes"] > 0


def test_quant_decode_report_uses_the_tp_group_size(monkeypatch):
    from roboticattack_torch.models import verify as tverify

    seen = []
    real = tquant.quantize_decode_params

    def record(tree, mode="int8", group_size=128):
        seen.append((mode, group_size))
        return real(tree, mode, group_size)

    monkeypatch.setattr(tquant, "quantize_decode_params", record)
    params = params_from_jax(jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(2))))
    rep = tverify.quant_decode_report(params, VLA_TINY, modes=("int4",), n_batches=1, batch_size=1, tp=4)
    assert seen == [("int4", j_group_size(J_TINY, tp=4))] and set(rep) == {"int4"}
