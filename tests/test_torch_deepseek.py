"""The DeepSeek-V3 decoder of the port (models/deepseek.py: latent attention,
a dense first layer, sparse experts with shared experts) on a tiny
Moonlight-shaped configuration on the CPU (tests/deepseek_tiny.py), against
the benchmark's plain float32 reference (vlabench/reference/moe.py): the
decoder's logits, a VLA's patch gradient, the routing with a correction
bias, the grouped expert product, recomputation, the benchmark's
configuration and FLOP count, and the paths that refuse the decoder. The
JAX package has no such decoder, so nothing here compares with it."""

import dataclasses
import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deepseek_tiny import CONFIG, e_bias, tiny_moonlight
from roboticattack_torch.attacks import engine
from roboticattack_torch.models import deepseek, vlm
from roboticattack_torch.models.config import VLA_MOONLIGHT_16B_A3B, get_config
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_plain
from roboticattack_torch.utils.normalization import dual_normalize
from vlabench import calibrate_moe
from vlabench.common import inputs, moe_flops, routing
from vlabench.common.program_moe import vla_config
from vlabench.reference import moe as ref
from vlabench.reference import vla as ref_vla

CELL = "attack-uada-moonlight16b-bs8"


def tiny(remat=False, seed=0, bias=True):
    cfg = tiny_moonlight()
    vcfg = dataclasses.replace(vla_config(cfg), remat=remat)
    params = init_vla_params(torch.Generator().manual_seed(seed), vcfg)
    if bias:
        e_bias(params)
    return cfg, vcfg, params


def decoder_inputs(cfg, seed=1, b=2, n=5, t=8):
    """Visual tokens [b, n, D], text ids [b, t] with the second row padded
    after 5 tokens, and its mask."""
    g = torch.Generator().manual_seed(seed)
    vis = torch.randn(b, n, cfg["hidden_size"], generator=g)
    ids = torch.randint(1, 32000, (b, t), generator=g)
    mask = torch.ones(b, t, dtype=torch.long)
    mask[1, 5:] = 0
    return vis, ids, mask


def program_text_logits(vcfg, params, vis, ids, mask):
    llm = params["llm"]
    emb = llm["embed"][ids]
    x = torch.cat([emb[:, :1], vis, emb[:, 1:]], dim=1)
    mm = torch.cat([mask[:, :1], torch.ones(vis.shape[:2], dtype=mask.dtype), mask[:, 1:]], dim=1)
    return deepseek.deepseek_apply(llm, vcfg.llm, x, attention_mask=mm, remat=vcfg.remat, logits_tail=ids.shape[1])


@pytest.mark.parametrize("bias", [True, False], ids=["e_bias", "zero_bias"])
def test_decoder_logits_equal_the_reference(bias):
    cfg, vcfg, params = tiny(bias=bias)
    vis, ids, mask = decoder_inputs(cfg)
    got = program_text_logits(vcfg, params, vis, ids, mask)
    with ref_vla.float32_exact():
        want = ref.text_logits(ref_vla.Precision(), cfg, params, ids, mask, vis, None)
    assert got.shape == want.shape == (2, 8, cfg["vocab_size"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _patch_grads(seed):
    cfg, vcfg, params = tiny(seed=seed)
    size = cfg["vision"]["towers"][0]["image_size"]
    nb = next(inputs.batches(seed, size, 2, 32))
    batch = engine.batch_to_device(engine.AttackBatch(*nb), "cpu")
    d = inputs.step_draws(seed, 0, 1, 2, size, 10)[0]
    spec = engine.AttackSpec(objective="uada", inner_loop=1)
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    patch = inputs.initial_patch(seed, 10)
    loss, _, grad = engine.patch_loss_and_grad(spec, vcfg, params, patch, batch, labels, engine.PatchDraws(*d))
    with ref_vla.float32_exact():
        p = patch.clone().requires_grad_(True)
        imgs = ref_vla.patched_images(batch.images, p, d.xy.tolist(), d.matrix)
        vis = ref_vla.visual_tokens(ref_vla.Precision(), cfg, params, imgs)
        want_loss = ref_vla.uada_loss(ref.text_logits(ref_vla.Precision(), cfg, params, batch.input_ids,
                                                      batch.attention_mask, vis, None), batch.labels)
        (want,) = torch.autograd.grad(want_loss, p)
    return loss, grad, want_loss.detach(), want


@pytest.mark.parametrize("seed", [3, 4])
def test_a_tiny_vlas_patch_gradient_equals_the_reference(seed):
    """The whole path: patch, towers, projector, this decoder, UADA, the
    gradient with respect to the patch pixels, in float32."""
    loss, grad, want_loss, want = _patch_grads(seed)
    assert want.abs().max() > 0
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_the_first_outer_step_follows_the_reference_through_the_harness():
    """The benchmark's own comparison (5 inner steps of AdamW, the
    reference on the program's expert choice) on the tiny configuration in
    float32: to rounding, and the same experts at the first sparse layer."""
    got = calibrate_moe.readings(CELL, 5, False, "cpu", tiny_moonlight())["program"]
    assert got["loss_gap"] < 1e-5 and got["m_norm_gap"] < 1e-4 and got["delta_norm_gap"] < 1e-4, got
    assert got["m_diff"] < 1e-4 and got["delta_diff"] < 1e-3, got
    assert got["route_miss"] == 0, got


def test_the_stand_ins_fail_the_numbers_their_fault_moves():
    """calibrate_moe's stand-ins on the tiny configuration: each reference
    runs its experts on the program's choice, so choosing without the
    correction bias moves route_miss alone; the half batch and the faults
    of the experts move the other numbers."""
    got = calibrate_moe.readings(CELL, 6, True, "cpu", tiny_moonlight())
    assert set(calibrate_moe.KINDS) <= set(got)
    unbiased = got["unbiased_routing"]
    assert unbiased["route_miss"] > 0.2 and unbiased["m_diff"] == unbiased["delta_diff"] == 0, unbiased
    assert got["control"]["route_miss"] > got["program"]["route_miss"]
    for kind in ("half_batch", "no_shared_experts", "routed_scale_1"):
        assert got[kind]["m_diff"] > 1e3 * max(got["program"]["m_diff"], 1e-7), (kind, got[kind])


def test_the_driver_keeps_the_first_outer_steps_choice():
    """The sparse-expert driver's set-up: the correction bias balanced on
    frames of its own, then one expert choice a sparse layer and inner step
    of the first outer step, whole-batch [B * S, k], the first layer's on
    the CPU for route_miss; the program's own function is back after."""
    from vlabench import run

    original = deepseek.choose_experts
    cell, _, traffic = run.cell_files(CELL)
    driver = run.load_module("drivers", cell["driver"]).Driver(tiny_moonlight(), traffic, cell, 9,
                                                               torch.device("cpu"))
    driver.setup()
    assert deepseek.choose_experts is original
    llm, inner = driver.vcfg.llm, traffic["inner_loop"]
    routes = driver.first["routes"]
    assert len(routes) == inner and all(len(r) == llm.num_moe_layers for r in routes)
    tokens = traffic["batch_size"] * (16 + traffic["pad_to"])  # 16 fused patch tokens, BOS and the text
    assert routes[0][0].shape == (tokens, llm.num_experts_per_tok)
    assert all(torch.equal(c, r[0]) for c, r in zip(driver.first["chosen"], routes))
    assert driver.params["llm"]["moe"]["e_bias"].any()
    assert driver.balanced["last"] < driver.balanced["first"]


def test_the_bias_chooses_the_experts_and_the_scores_weigh_them():
    """e_bias moves a token's choice but not its weights: the weights are the
    chosen experts' unbiased scores, normalized and scaled; the reference
    routes alike."""
    cfg = vla_config(tiny_moonlight()).llm
    scores = torch.tensor([[0.9, 0.8, 0.1, 0.2, 0.5, 0.4, 0.3, 0.6]])
    none, shift = torch.zeros(8), torch.zeros(8)
    shift[2] = 1.0  # expert 2 (score 0.1) overtakes expert 1 (0.8)
    assert sorted(deepseek.choose_experts(cfg, scores, none)[0].tolist()) == [0, 1]
    idx = deepseek.choose_experts(cfg, scores, shift)
    assert sorted(idx[0].tolist()) == [0, 2]
    w = deepseek.gate_weights(cfg, scores, idx)
    want = {0: 0.9 / 1.0 * 2.446, 2: 0.1 / 1.0 * 2.446}
    for j, e in enumerate(idx[0].tolist()):
        assert float(w[0, j]) == pytest.approx(want[e], rel=1e-6)


def test_the_sparse_layer_with_a_bias_equals_the_reference():
    cfg, vcfg, params = tiny()
    moe = {k: t[0] for k, t in params["llm"]["moe"].items()}
    y = torch.randn(2, 7, cfg["hidden_size"], generator=torch.Generator().manual_seed(2))
    routes = {}
    got = deepseek.moe(vcfg.llm, y, moe, routes, 1)
    unbiased = deepseek.choose_experts(vcfg.llm, deepseek.router_scores(y.reshape(14, -1), moe["router_w"]),
                                       torch.zeros(8))
    assert not torch.equal(routes[1].sort(-1).values, unbiased.sort(-1).values)  # the bias changed choices
    with ref_vla.float32_exact():
        pr = ref_vla.Precision()
        want = ref.sparse_experts(pr, cfg, params["llm"]["moe"], 0, y.reshape(14, -1), None).reshape(2, 7, -1)
        want = want + ref.swiglu(pr, y, moe["shared_gate_w"], moe["shared_up_w"], moe["shared_down_w"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_reference_runs_its_experts_on_the_given_choice():
    """Given a choice, the reference's sparse layer equals the program's
    routed experts on that choice, weighted by the reference's own scores,
    and still reports its own choice of the first sparse layer."""
    cfg, vcfg, params = tiny()
    m = params["llm"]["moe"]
    y = torch.randn(11, cfg["hidden_size"], generator=torch.Generator().manual_seed(12))
    scores = deepseek.router_scores(y, m["router_w"][0])
    own = deepseek.choose_experts(vcfg.llm, scores, m["e_bias"][0])
    given = (own + 3) % cfg["n_routed_experts"]  # every token on other experts
    seen = {}
    with ref_vla.float32_exact():
        got = ref.sparse_experts(ref_vla.Precision(), cfg, m, 0, y, None, given, seen)
    p = {k: m[k][0] for k in ("gate_w", "up_w", "down_w")}
    want = deepseek.routed_experts(y, given, deepseek.gate_weights(vcfg.llm, scores, given), p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(seen[0], own)


def test_route_miss_counts_the_tokens_whose_experts_differ():
    """Order within a token does not count; a stand-in on fewer rows is
    held to the first rows; unequal inner steps read inf."""
    want = [torch.tensor([[0, 1], [2, 3], [4, 5], [6, 7]])]
    got = [torch.tensor([[1, 0], [2, 4], [4, 5], [7, 6]])]
    assert ref.route_miss(got, want) == 0.25
    assert ref.route_miss([got[0][:2]], want) == 0.5
    assert ref.route_miss(got + got, want) == float("inf")


def test_balancing_evens_a_skewed_router():
    """routing.balance on a router whose scores favour a few experts: the
    choices it takes (routing.taken) go from most tokens on the favoured
    experts to near even, in the bias alone; the program's function is
    back after."""
    cfg = vla_config(tiny_moonlight()).llm
    g = torch.Generator().manual_seed(13)
    offset = torch.linspace(-1.5, 1.5, 8)
    params = {"llm": {"moe": {"e_bias": torch.zeros(2, 8)}}}
    original = deepseek.choose_experts

    def forward():
        for layer in range(2):
            scores = torch.sigmoid(torch.randn(512, 8, generator=g) * 0.5 + offset)
            deepseek.choose_experts(cfg, scores, params["llm"]["moe"]["e_bias"][layer])

    with routing.taken() as chosen:
        seen = routing.balance(params, forward, chosen)
        assert chosen == []
    assert deepseek.choose_experts is original
    assert seen["first"] > 2.5 and seen["last"] < 1.3, seen
    assert params["llm"]["moe"]["e_bias"][:, 0].gt(params["llm"]["moe"]["e_bias"][:, -1]).all()


def _loop_experts(y, idx, w, p):
    """Token by token: sum_k w[t, k] E_idx[t, k](y[t])."""
    rows = []
    for t in range(y.shape[0]):
        acc = 0
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            acc = acc + w[t, j] * deepseek.swiglu(y[t], p["gate_w"][e], p["up_w"][e], p["down_w"][e])
        rows.append(acc)
    return torch.stack(rows)


@pytest.mark.parametrize("empty", [True, False], ids=["an_expert_without_tokens", "every_expert"])
def test_the_grouped_experts_equal_the_per_expert_loop(empty):
    """The sorted rows through grouped products equal the token-by-token
    loop, forward and input gradient (through the experts' inputs and the
    gate weights)."""
    g = torch.Generator().manual_seed(5)
    e, d, f, t, k = 8, 16, 12, 9, 2
    p = {n: torch.randn(shape, generator=g) * 0.3 for n, shape in
         (("gate_w", (e, d, f)), ("up_w", (e, d, f)), ("down_w", (e, f, d)))}
    idx = torch.stack([torch.randperm(e - 1 if empty else e, generator=g)[:k] for _ in range(t)])
    y = torch.randn(t, d, generator=g, requires_grad=True)
    w = torch.rand(t, k, generator=g, requires_grad=True)
    got = deepseek.routed_experts(y, idx, w, p)
    want = _loop_experts(y, idx, w, p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    up = torch.randn(t, d, generator=g)
    gy, gw = torch.autograd.grad(got, (y, w), up)
    wy, ww = torch.autograd.grad(want, (y, w), up)
    torch.testing.assert_close(gy, wy, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-6)


def test_the_grouped_product_equals_a_product_per_group():
    """grouped_matmul on rows sorted into groups of 3, 0, 5 and 1 rows: each
    group times its own matrix, forward and gradient in both operands."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(9, 4, generator=g, requires_grad=True)
    w = torch.randn(4, 4, 3, generator=g, requires_grad=True)
    offs = torch.tensor([3, 3, 8, 9], dtype=torch.int32)
    got = grouped_matmul(x, w, offs)
    want = torch.cat([x[:3] @ w[0], x[3:8] @ w[2], x[8:] @ w[3]])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(grouped_matmul_plain(x, w, offs), want)
    up = torch.randn(9, 3, generator=g)
    for a, b in zip(torch.autograd.grad(got, (x, w), up), torch.autograd.grad(want, (x, w), up)):
        torch.testing.assert_close(a, b)


def test_recomputation_routes_as_the_forward_and_changes_nothing(monkeypatch):
    """The backward with per-block recomputation equals the one without,
    and the recomputation takes the forward's expert choice: each sparse
    layer chooses once."""
    cfg, vcfg, params = tiny()
    vis, ids, mask = decoder_inputs(cfg)
    chosen = []
    original = deepseek.choose_experts
    monkeypatch.setattr(deepseek, "choose_experts", lambda *a: chosen.append(1) or original(*a))
    grads = []
    for remat in (False, True):
        v = vis.clone().requires_grad_(True)
        logits = program_text_logits(dataclasses.replace(vcfg, remat=remat), params, v, ids, mask)
        (gv,) = torch.autograd.grad(logits.square().mean(), v)
        grads.append(gv)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert len(chosen) == 2 * vcfg.llm.num_moe_layers  # once a layer in each of the two passes


def test_the_benchmark_configuration_is_moonlight():
    """The configuration file gives the program MOONLIGHT_16B_A3B (the
    registry's VLA), holds the published numbers at the top level, and cuts
    nothing."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    assert vla_config(cfg) == VLA_MOONLIGHT_16B_A3B == get_config("vla-moonlight-16b-a3b")
    llm = VLA_MOONLIGHT_16B_A3B.llm
    assert (llm.qk_head_dim, llm.v_head_dim, llm.num_moe_layers, llm.shared_intermediate_size) == (192, 128, 26, 2816)
    assert cfg["reduced"] == [] and cfg["source"].startswith("https://huggingface.co/moonshotai/Moonlight-16B-A3B")
    assert (cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["routed_scaling_factor"]) == (64, 6, 2.446)


def test_a_variant_the_program_does_not_implement_is_refused():
    for key, value in (("q_lora_rank", 1536), ("scoring_func", "softmax"), ("n_group", 8)):
        cfg = dict(tiny_moonlight(), **{key: value})
        with pytest.raises(ValueError, match=key):
            vla_config(cfg)


def test_the_flop_count_equals_the_products_counted():
    """common/moe_flops.py against the matrix products the program runs
    (without recomputation): the routed experts counted at the k a token
    reads."""
    cfg, vcfg, params = tiny()
    size = cfg["vision"]["towers"][0]["image_size"]
    batch = engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, size, 2, 32))), "cpu")
    d = inputs.step_draws(3, 0, 1, 2, size, 50)[0]
    spec = engine.AttackSpec(objective="uada", inner_loop=1)
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    with FlopCounterMode(display=False) as counter:
        engine.patch_loss_and_grad(spec, vcfg, params, inputs.initial_patch(3, 50), batch, labels,
                                   engine.PatchDraws(*d))
    assert counter.get_total_flops() == moe_flops.attack_inner_step(cfg, 2, 32)


def test_the_cells_counts_and_bound():
    """27.9 TFLOP an inner step at bs 8 and prompts of 32; the routed
    experts' 234 grouped products an inner step at 32.5 ms by their bytes."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    assert moe_flops.attack_inner_step(cfg, 8, 32) == pytest.approx(27.919e12, rel=1e-4)
    products, flop, nbytes = moe_flops.routed_expert_products(cfg, 8, 32)
    assert (products, flop) == (234, 2 * 8 * 288 * 6 * 2048 * 1408)
    assert nbytes == 2 * (64 * 2048 * 1408 + 8 * 288 * 6 * (2048 + 1408))
    assert moe_flops.routed_expert_bound_s(cfg, 8, 32) == pytest.approx(234 * nbytes / 3.35e12)


def test_the_draw_is_seeded_and_the_experts_are_drawn_by_layer():
    _, vcfg, a = tiny(bias=False)
    _, _, b = tiny(bias=False)
    leaves = dict(vlm.tree_leaves(a))
    for path, leaf in vlm.tree_leaves(b):
        assert torch.equal(leaf, leaves[path]), path
    moe = a["llm"]["moe"]
    llm = vcfg.llm
    assert moe["gate_w"].shape == (2, llm.n_routed_experts, llm.hidden_size, llm.moe_intermediate_size)
    assert moe["e_bias"].dtype == torch.float32 and not moe["e_bias"].any()
    assert a["llm"]["layers"]["q_w"].shape == (3, 64, 4 * 24)


@pytest.mark.parametrize("path", ["model_axis", "load_policy", "policy", "decode", "trainer"])
def test_the_paths_without_this_decoder_refuse_it(path):
    from roboticattack_torch.eval import policy
    from roboticattack_torch.models import decode
    from roboticattack_torch.training.strategies import TrainConfig, VLATrainer

    cfg, vcfg, params = tiny()
    ids = torch.ones(1, 4, dtype=torch.long)
    calls = {
        "model_axis": lambda: vlm.vla_forward(params, vcfg, ids, torch.ones_like(ids), None, mesh=types.SimpleNamespace(tp=2)),
        "load_policy": lambda: policy.load_policy(model_name="vla-moonlight-16b-a3b", device="cpu"),
        "policy": lambda: policy.VLAPolicy(params, vcfg, None, {}, device="cpu"),
        "decode": lambda: decode.greedy_decode_actions(params, vcfg, ids, torch.ones_like(ids),
                                                       torch.zeros(1, 2, 56, 56, 3)),
        "trainer": lambda: VLATrainer(params, vcfg, TrainConfig(), device="cpu"),
    }
    with pytest.raises(ValueError, match="DeepSeek-V3"):
        calls[path]()


def test_the_reference_plants_the_sparse_layer_faults():
    """Each fault of reference/moe.py changes the decoder's logits; an
    unknown one is refused."""
    cfg, _, params = tiny()
    vis, ids, mask = decoder_inputs(cfg)
    with ref_vla.float32_exact():
        pr = ref_vla.Precision()
        exact = ref.text_logits(pr, cfg, params, ids, mask, vis, None)
        for fault in ref.FAULTS:
            assert (ref.text_logits(pr, cfg, params, ids, mask, vis, fault) - exact).abs().max() > 1e-4, fault
    with pytest.raises(ValueError):
        ref.attack_steps(cfg, params, None, None, [], 1e-3, "cpu", fault="no_experts")


def test_dual_normalized_pixels_feed_the_program_as_the_reference_normalizes():
    """The program takes dual-normalized pixels and the reference
    normalizes each tower's view itself: the projected tokens agree."""
    cfg, vcfg, params = tiny()
    images = torch.rand(2, 56, 56, 3, generator=torch.Generator().manual_seed(8))
    got = vlm.projector_apply(params["projector"], vlm.vision_features(params["vision"], vcfg, dual_normalize(images)))
    with ref_vla.float32_exact():
        want = ref_vla.visual_tokens(ref_vla.Precision(), cfg, params, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_the_cards_readings_under_the_cell_limits():
    """The readings `calibrate_moe.py` took on the card at the cell's own
    size (vlabench/calibration/<cell>.jsonl: the program on 12 seeds; the
    float8 control, the half batch and both faults of the sparse-expert
    layer on 3), put through the comparison that decides `correct` with the
    cell's limits: the program is correct on every seed, the others on
    none."""
    import os

    from vlabench import calibrate_moe, run
    from vlabench.reference import compare

    limits = run.cell_files(CELL)[0]["limits"]
    with open(os.path.join(run.HERE, "calibration", CELL + ".jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "seed" in r]
    assert len(rows) >= 12
    for kind in calibrate_moe.KINDS[1:]:
        assert sum(kind in r for r in rows) >= 3, kind
    for r in rows:
        got = {k: compare.holds(compare.held(r[k], limits)) for k in calibrate_moe.KINDS if k in r}
        assert got.pop("program") is True, r
        assert not any(got.values()), (r["seed"], got)
