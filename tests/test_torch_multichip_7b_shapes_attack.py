"""The 7B attack step's data- and tensor-parallel layout at full shape, audited
on meta tensors (roboticattack_torch/parallel/evidence.py: one rank at a
time under a fake process group, no weights, no card): the port's
counterpart of the attack cases of the JAX package's
tests/test_multichip_7b_shapes.py, at the same shapes (bs 8, pad 32, so S =
288 with the 256 patches).

Each case audits rank 0 and, where its groups differ, the last rank. A
rank's parameter bytes equal JAX's bytes for one device's shards of the
same leaves exactly, leaf by leaf (tests/torch_multichip_shapes.py); its
argument bytes fall in the JAX test's window."""

import pytest

from roboticattack_torch.parallel.evidence import audit_attack_step_7b, evidence_7b_config, memory_summary
from torch_multichip_shapes import KB, MB, assert_params_equal_jax, by_kind

CFG = evidence_7b_config()
BS, PAD = 8, 32
PATCH = (50, 50, 3)


def tp_attack_kind(c, cfg, tp: int, dp: int, rank: int):
    """The kind of one collective of a rank's attack step (the classes of
    chip_smoke.py's tp_attack_inventory): the data group's patch gradient
    and packed sums; the model group's activation sums by [B_local, S,
    width], its sub-MB row statistics by op and argmax (value, id) pairs.
    None for anything else, and for any tensor with a dim of a logits row
    (V / tp or V)."""
    b, d = BS // dp, cfg.llm.hidden_size
    v = cfg.llm.vocab_size
    d_idx, m_idx = divmod(rank, tp)
    model = tuple(d_idx * tp + i for i in range(tp))
    data = tuple(i * tp + m_idx for i in range(dp))
    if v in c.shape or v // tp in c.shape:
        return None
    if c.ranks == data and c.name == "all_reduce" and c.op == "SUM" and c.shape == PATCH:
        return "data: patch gradient"
    if c.ranks == data and c.name == "all_reduce" and c.op == "SUM" and len(c.shape) == 1:
        return "data: packed sums"
    if c.ranks == model and c.name == "all_reduce" and c.op == "SUM" and len(c.shape) == 3 \
            and c.shape[0] == b and c.shape[2] in (d, cfg.vision_dim) and c.dtype == "torch.bfloat16":
        return f"model: sum {list(c.shape)}"
    if c.ranks == model and c.name == "all_reduce" and c.nbytes < MB:
        return f"model: row statistics {c.op}"
    if c.ranks == model and c.name == "all_gather" and c.nbytes * tp < MB:
        return "model: argmax pairs"
    return None


def tp_attack_want(cfg, dp: int, shard_projector: bool, objective: str) -> dict:
    """One inner step's collectives by kind (the hand reckoning chip_smoke.py
    held its tp_attack ranks to before the audit took its place, copied
    here): one patch and one packed-sums all-reduce
    on the data group; on the model group 5 [B_local, 288, 4096] sums a
    layer under remat (o and down forward, the gradients of the two copies
    before q/k/v and gate/up, and o's again in the re-forward, which stops
    after down's product), the embed lookup's and lm_head's input gradient
    ([B_local, 32, 4096]), and under shard_projector fc2's sum (forward and
    re-forward) and fc1's input gradient; a MAX and a SUM of row statistics
    per log-softmax or expectation, one gather per argmax (UPA reads
    expectations only, and has none)."""
    b, d, p = BS // dp, cfg.llm.hidden_size, cfg.num_patches
    per_layer = 5 if cfg.remat else 4
    stats = 1 if objective == "tma" else 2
    want = {"data: patch gradient": 1, "data: packed sums": 1,
            f"model: sum {[b, p + PAD, d]}": per_layer * cfg.llm.num_layers,
            f"model: sum {[b, PAD, d]}": 2, "model: row statistics MAX": stats,
            "model: row statistics SUM": stats}
    if objective != "upa":
        want["model: argmax pairs"] = 1
    if shard_projector:
        want[f"model: sum {[b, p, d]}"] = 2 if cfg.remat else 1
        want[f"model: sum {[b, p, cfg.vision_dim]}"] = 1
    return want


@pytest.mark.parametrize("objective,inner_loop,shard_projector",
                         [("uada", 2, False), ("tma", 1, False), ("upa", 1, False), ("uada", 1, True)])
@pytest.mark.parametrize("rank", [0, 7])
def test_attack_step_dp4_tp2_7b_inventory_and_memory(objective, inner_loop, shard_projector, rank):
    """dp 4 x tp 2, bs 8 global (2 rows a replica), pad 32 (S = 288): per
    inner step exactly one patch-gradient all-reduce on the data group, the
    Megatron activation sums, row statistics and one argmax gather on the
    model group (with shard_projector, also fc2's sums and fc1's input
    gradient); no collective has a dim of V or V/tp, every gather stays
    under 1 MB, and nothing else is called (the audit refuses any other
    collective). The rank holds JAX's per-device shards (7.69 GiB with the
    projector whole); its arguments fall in JAX's window (7.0, 8.5) GiB."""
    audit = audit_attack_step_7b(4, 2, rank, batch_size=BS, pad_to=PAD, objective=objective, inner_loop=inner_loop,
                                 shard_projector=shard_projector)
    kinds = by_kind(audit, lambda c: tp_attack_kind(c, CFG, 2, 4, rank))
    want = {k: n * inner_loop for k, n in tp_attack_want(CFG, 4, shard_projector, objective).items()}
    assert kinds == want
    assert all(c.nbytes * 2 < MB for c in audit.collectives if c.name == "all_gather")
    assert assert_params_equal_jax(audit, 4, 2, shard_projector=shard_projector) == \
        memory_summary(audit)["param_bytes"]
    mem = memory_summary(audit)
    assert 7.0 < mem["argument_gb"] < 8.5, mem


def test_attack_step_pure_dp8_7b_single_patch_psum():
    """Pure data parallelism over 8 ranks at 7B shapes: only all-reduces
    over the data group (the world), one [50, 50, 3] patch gradient an
    inner step and the rest under 1 KB (the packed sums); each rank holds
    the whole 7B, JAX's replicated leaves."""
    inner = 2
    audit = audit_attack_step_7b(8, 1, 0, batch_size=BS, pad_to=PAD, inner_loop=inner)
    world = tuple(range(8))
    n_patch = 0
    for c in audit.collectives:
        assert c.name == "all_reduce" and c.op == "SUM" and c.ranks == world, c
        if c.shape == PATCH:
            n_patch += 1
        else:
            assert c.nbytes < KB, c
    assert n_patch == inner
    assert assert_params_equal_jax(audit, 8, 1) == memory_summary(audit)["param_bytes"]
