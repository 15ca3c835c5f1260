"""The 7B serving decode's tensor- and data-parallel layout at full shape,
audited on meta tensors (roboticattack_torch/parallel/evidence.py: one rank
at a time under a fake process group, no weights, no card): the port's
counterpart of the decode cases of the JAX package's
tests/test_multichip_7b_shapes.py, at the same shapes (a prompt of 64, so a
prefill of 320 with the 256 patches), and the audit's own guards.

Each case audits rank 0 and, where its groups differ, the last rank. A
rank's parameter bytes equal JAX's bytes for one device's shards of the
same leaves of the cooked (quantized) tree exactly, leaf by leaf (the int8
embed of a quantized tree included: JAX's quantize_decode_shapes makes it
too); its argument bytes fall in the JAX test's window. A gather's bytes
are what one rank gives."""

import pytest
import torch
import torch.distributed as dist

from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.parallel import mesh as tmesh
from roboticattack_torch.parallel.evidence import audit_decode, audit_decode_7b, evidence_7b_config, memory_summary
from roboticattack_torch.utils.profiling import counting_collectives
from torch_multichip_shapes import MB, assert_params_equal_jax

CFG = evidence_7b_config()
L, D, V = CFG.llm.num_layers, CFG.llm.hidden_size, CFG.llm.vocab_size
PREFILL = 64 + CFG.num_patches  # 320
N = 7  # action tokens


def _decode_inventory(audit, bs: int, tp: int, tail_s: int = 1):
    """The decode's collectives by (name, op, shape, dtype), each over the
    rank's model group (the world for the Jacobi flag), after asserting
    that no tensor has a weight's or a cache's size: every all-reduce is an
    activation [bs, S, 4096] or under 1 MB, every gather a [bs, s, V/tp]
    logits row under 16 MB."""
    model = tuple(range(audit.rank // tp * tp, audit.rank // tp * tp + tp))
    kinds = {}
    for c in audit.collectives:
        assert c.name in ("all_reduce", "all_gather"), c
        if c.name == "all_reduce" and c.nbytes >= MB:
            assert c.ranks == model and c.shape in ((bs, PREFILL, D), (bs, tail_s, D)), c
        elif c.name == "all_gather":
            assert c.ranks == model and c.shape[-1] == V // tp and c.nbytes < 16 * MB, c
        else:
            assert c.ranks in (model, "world"), c
        key = (c.name, c.op, c.ranks == "world", c.shape, c.dtype)
        kinds[key] = kinds.get(key, 0) + 1
    return kinds


def _audit(dp, tp, rank, quantize=None, jax_quantize=False, window=None, **kw):
    audit = audit_decode_7b(dp, tp, rank, quantize=quantize, **kw)
    assert assert_params_equal_jax(audit, dp, tp, cooked=True, quantize=jax_quantize) == \
        memory_summary(audit)["param_bytes"]
    if window is not None:
        mem = memory_summary(audit)
        assert window[0] < mem["argument_gb"] < window[1], mem
    return audit


@pytest.mark.parametrize("rank", [0, 1])
def test_decode_tp2_7b_inventory_and_memory(rank):
    """tp 2 at bs 8: two all-reduces a layer of [8, 320, 4096] in the
    prefill and of [8, 1, 4096] in each of the 6 cached steps, one logits
    gather a token ([8, 1, V/2] f32, 0.5 MB a rank) and nothing else: no
    weight or KV cache crosses. JAX's shards, arguments in (7.0, 8.5) GiB."""
    audit = _audit(1, 2, rank, batch_size=8, window=(7.0, 8.5))
    bf16, f32 = "torch.bfloat16", "torch.float32"
    assert _decode_inventory(audit, 8, 2) == {
        ("all_reduce", "SUM", False, (8, PREFILL, D), bf16): 2 * L,
        ("all_reduce", "SUM", False, (8, 1, D), bf16): 2 * L * (N - 1),
        ("all_gather", None, False, (8, 1, V // 2), f32): N}
    assert all(c.nbytes < MB for c in audit.collectives if c.name == "all_gather")


def test_decode_int8_single_chip_bs8_memory():
    """Int8 weight-only serving at bs 8 on one rank: no collective;
    JAX's int8 tree (embed and lm_head int8 with f32 scales), arguments in
    (7.5, 7.9) GiB."""
    audit = _audit(1, 1, 0, "int8", True, batch_size=8, window=(7.5, 7.9))
    assert audit.collectives == []


def test_decode_int4_single_chip_bs16_memory():
    """Grouped int4 (groups of 128) at bs 16 on one rank: no collective;
    arguments in (4.6, 5.2) GiB."""
    audit = _audit(1, 1, 0, "int4", "int4", batch_size=16, window=(4.6, 5.2))
    assert audit.collectives == []


@pytest.mark.parametrize("rank", [0, 1])
def test_decode_int4_tp2_no_weight_gather(rank):
    """int4 at tp 2, bs 16 (groups of 128, int4_group_size_for(7B, 2)): the
    grouped scales are cut with their stacks, and what crosses is the bf16
    inventory at bs 16; arguments under 3.4 GiB."""
    audit = _audit(1, 2, rank, "int4", "int4", batch_size=16, window=(0.0, 3.4))
    bf16, f32 = "torch.bfloat16", "torch.float32"
    assert _decode_inventory(audit, 16, 2) == {
        ("all_reduce", "SUM", False, (16, PREFILL, D), bf16): 2 * L,
        ("all_reduce", "SUM", False, (16, 1, D), bf16): 2 * L * (N - 1),
        ("all_gather", None, False, (16, 1, V // 2), f32): N}


@pytest.mark.parametrize("rank", [0, 1])
def test_decode_jacobi_tp2_inventory_and_memory(rank):
    """The Jacobi decode at tp 2, bs 8, with a draft of zeros: on meta every
    verification pass runs, n - 1 = 6 of them (JAX's while_loop bound). Each
    pass sums [8, 7, 4096] twice a layer, gathers one [8, 7, V/2] logits
    block (3.6 MB a rank) and issues one MAX flag over the world, in that
    order; the prefill's sums and its one-token gather come first. JAX's
    shards, arguments in (7.0, 8.5) GiB."""
    audit = _audit(1, 2, rank, batch_size=8, jacobi=True, window=(7.0, 8.5))
    bf16, f32 = "torch.bfloat16", "torch.float32"
    assert _decode_inventory(audit, 8, 2, tail_s=N) == {
        ("all_reduce", "SUM", False, (8, PREFILL, D), bf16): 2 * L,
        ("all_gather", None, False, (8, 1, V // 2), f32): 1,
        ("all_reduce", "SUM", False, (8, N, D), bf16): 2 * L * (N - 1),
        ("all_gather", None, False, (8, N, V // 2), f32): N - 1,
        ("all_reduce", "MAX", True, (1,), "torch.int32"): N - 1}
    tail = audit.collectives[2 * L + 1:]
    per_pass = 2 * L + 2
    for i in range(N - 1):  # a pass: the layers' sums, its gather, then its flag
        one = tail[i * per_pass:(i + 1) * per_pass]
        assert [c.name for c in one[-2:]] == ["all_gather", "all_reduce"] and one[-1].op == "MAX", i


@pytest.mark.parametrize("rank", [0, 1])
def test_decode_w8a8_tp2_inventory_and_memory(rank):
    """w8a8 at tp 2, bs 16: the prefill's row-parallel partial sums cross as
    int32 [16, 320, 4096] (exact), with the per-token absmax MAX under 1 MB
    before each; the weight-only int8 tail sums [16, 1, 4096] in f32. The
    int8 tree's shards, arguments in (3.5, 5.0) GiB."""
    audit = _audit(1, 2, rank, "int8", True, batch_size=16, act_quant="int8", window=(3.5, 5.0))
    f32 = "torch.float32"
    assert _decode_inventory(audit, 16, 2) == {
        ("all_reduce", "MAX", False, (16, PREFILL, 1), f32): 2 * L,
        ("all_reduce", "SUM", False, (16, PREFILL, D), "torch.int32"): 2 * L,
        ("all_reduce", "SUM", False, (16, 1, D), f32): 2 * L * (N - 1),
        ("all_gather", None, False, (16, 1, V // 2), f32): N}


@pytest.mark.parametrize("rank", [0, 1])
def test_decode_pure_dp2_no_collectives(rank):
    """Pure data parallelism (dp 2, int8): each replica decodes its 4 rows
    with no collective at all; each rank holds the whole int8 tree."""
    audit = _audit(2, 1, rank, "int8", True, batch_size=8)
    assert audit.collectives == []
    assert audit.inputs[0].shape == (4, 64)


# ------------------------------------------------------------------ the audit's guards


def test_audit_refuses_any_other_collective_and_leaves_no_process_group(monkeypatch):
    """A collective other than all_reduce / all_gather / broadcast on the
    audited path (here a barrier before each model-group sum) fails the
    audit (the recorded log holds it), and the fake process group is gone
    after it."""
    real = tmesh.model_all_reduce

    def with_a_barrier(t, mesh, op=dist.ReduceOp.SUM):
        dist.barrier()
        return real(t, mesh, op)

    monkeypatch.setattr(tmesh, "model_all_reduce", with_a_barrier)
    with pytest.raises(RuntimeError, match="torch.distributed.barrier"):
        audit_decode(VLA_TINY, 1, 2, 0, batch_size=2, prompt_pad=8)
    assert not dist.is_initialized()
    monkeypatch.undo()
    assert audit_decode(VLA_TINY, 1, 2, 0, batch_size=2, prompt_pad=8).collectives
    assert not dist.is_initialized()


def test_audit_refuses_a_process_group_it_did_not_make():
    """The audit forms its own world: with one initialized it raises and
    leaves that one as it was. Outside an audit, counting_collectives
    records any other collective by name."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="has one initialized"):
            audit_decode(VLA_TINY, 1, 1, 0, batch_size=1, prompt_pad=8)
        assert dist.is_initialized()
        log = []
        with counting_collectives(log):
            dist.barrier()
            dist.all_reduce(torch.ones(3))
        assert [(c.name, c.shape) for c in log] == [("barrier", ()), ("all_reduce", (3,))]
    finally:
        dist.destroy_process_group()


def test_meta_jacobi_decode_runs_every_pass_and_flags_each_under_a_mesh():
    """On meta the Jacobi tail has nothing to read: it runs n - 1 passes and
    issues one MAX flag over the world a pass (ServingMesh.any_rank still
    calls its all-reduce); the mesh's place is make_serving_mesh's (rank =
    d * tp + m over dp 2 x tp 2)."""
    audit = audit_decode(VLA_TINY, 2, 2, 3, batch_size=4, prompt_pad=8, jacobi=True)
    flags = [c for c in audit.collectives if c.op == "MAX"]
    assert [(c.ranks, c.shape) for c in flags] == [("world", (1,))] * (N - 1)
    assert {c.ranks for c in audit.collectives if c.op != "MAX"} == {(2, 3)}
