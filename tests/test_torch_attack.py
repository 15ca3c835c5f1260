"""The pieces of the port's attack step against the JAX package on VLA_TINY
(fp32, CPU): the dummy data and collator (bit-equal batches), the label
rewrites, every objective and metric of `attacks/losses.py`, the optimizer
and schedule, and the training-style forward (`llama_apply`, `vla_forward`)
under each `attn_impl`.

Tolerances: integer outputs exact; losses rtol 1e-5 (the same f32 formulas,
sums in another order); forwards rtol 1e-4 / atol 1e-5 (a few f32 ulps per
op over the layers, as tests/test_torch_vision.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.attacks import losses as jl
from roboticattack_tpu.attacks import optimizer as jopt
from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.models import llama as jllama
from roboticattack_tpu.models import vlm as jvlm
from roboticattack_tpu.utils import labels as jlabels
from roboticattack_tpu.utils.normalization import dual_normalize as jdual
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_tpu.utils.prompting import build_vla_example as jbuild
from roboticattack_torch.attacks import losses as tl
from roboticattack_torch.attacks import optimizer as topt
from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
from roboticattack_torch.models import llama as tllama
from roboticattack_torch.models import vlm as tvlm
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.utils import labels as tlabels
from roboticattack_torch.utils.constants import ACTION_TOKEN_MIN, N_ACTION_BINS
from roboticattack_torch.utils.prompting import WordStubTokenizer, build_vla_example

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def with_impl(cfg, impl, remat=False):
    return dataclasses.replace(cfg, remat=remat, llm=dataclasses.replace(cfg.llm, attn_impl=impl))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_vla_params(jax.random.key(5), VLA_TINY))


@pytest.fixture(scope="module")
def batch():
    """A bs-3 dummy batch of the JAX package (pad_to 48, 56x56 frames)."""
    frames = jdummy(JaxStub(), image_size=56, seed=3)
    return next(jbatch_iterator(frames, batch_size=3, pad_to=48))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,bs,pad_to", [(0, 2, 48), (42, 8, 32), (7, 3, None)])
def test_dummy_batches_are_bit_equal(seed, bs, pad_to):
    want = jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=seed), bs, pad_to=pad_to)
    got = batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=56, seed=seed), bs, pad_to=pad_to)
    for _ in range(3):
        w, g = next(want), next(got)
        for a, b in zip(g, w):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_build_vla_example_matches_jax():
    action = np.array([0.3, -0.9, 1.0, -1.0, 0.0, 0.5, 1.0])
    for instr in ("pick up the red bowl", "Open The Drawer"):
        for stop in (True, False):
            g = build_vla_example(instr, action, WordStubTokenizer(), predict_stop_token=stop)
            w = jbuild(instr, action, JaxStub(), predict_stop_token=stop)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ labels
def test_label_rewrites_match_jax(batch):
    labels = np.asarray(batch.labels)
    tlab = _t(labels).long()
    for maskidx in ([0], [6], [0, 1, 2], [0, 1, 2, 3, 4, 5, 6]):
        np.testing.assert_array_equal(tlabels.maskidx_to_onehot(maskidx), jlabels.maskidx_to_onehot(maskidx))
        target = jlabels.build_tma_target_tokens(np.full(7, 0.4), maskidx)
        np.testing.assert_array_equal(tlabels.build_tma_target_tokens(np.full(7, 0.4), maskidx), target)
        np.testing.assert_array_equal(
            tlabels.overwrite_with_target(tlab, _t(target)).numpy(),
            np.asarray(jlabels.overwrite_with_target(jnp.asarray(labels), jnp.asarray(target))))
        masked = np.asarray(jlabels.mask_labels(jnp.asarray(labels), maskidx))
        np.testing.assert_array_equal(tlabels.mask_labels(tlab, maskidx).numpy(), masked)
        key = jax.random.key(sum(maskidx))
        coin = np.asarray(jax.random.bernoulli(key, 0.5, labels.shape))
        np.testing.assert_array_equal(
            tlabels.change_target(_t(masked).long(), _t(coin)).numpy(),
            np.asarray(jlabels.change_target(jnp.asarray(masked), key)))
    np.testing.assert_array_equal(tlabels.extract_action_tokens(tlab).numpy(),
                                  np.asarray(jlabels.extract_action_tokens(jnp.asarray(labels))))
    np.testing.assert_array_equal(tlabels.gripper_open_rows(tlab).numpy(),
                                  np.asarray(jlabels.gripper_open_rows(jnp.asarray(labels))))


# ------------------------------------------------------------------ losses
@pytest.fixture(scope="module")
def logits(batch):
    """Random [B, S, V] f32 logits with the action slice boosted, so argmax
    lands on action tokens and the metrics see hits and misses."""
    rng = np.random.default_rng(11)
    b, s = np.asarray(batch.labels).shape
    lg = rng.standard_normal((b, s, VLA_TINY.llm.vocab_size)).astype(np.float32)
    lg[..., ACTION_TOKEN_MIN:ACTION_TOKEN_MIN + N_ACTION_BINS] += 4.0
    return lg


def _close(got, want, tol=LOSS_TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64),
                               np.asarray(want, np.float64), **tol)


@pytest.mark.parametrize("maskidx", [[0, 1, 2, 3, 4, 5, 6], [6], [0, 1, 2]])
def test_every_loss_matches_jax(batch, logits, maskidx):
    cfg_t, cfg_j = T_TINY, VLA_TINY
    labels = np.asarray(jlabels.mask_labels(jnp.asarray(batch.labels), maskidx))
    jlg, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tlg, tlab = _t(logits), _t(labels).long()
    ce_j = jllama.cross_entropy_loss(jlg, jlab)
    ce_t = tllama.cross_entropy_loss(tlg, tlab)
    _close(ce_t, ce_j)

    for g, w in zip(tl.tma_metrics(tlg, tlab, ce_t, cfg_t), jl.tma_metrics(jlg, jlab, ce_j, cfg_j)):
        _close(g, w)
    for add in (True, False):
        for g, w in zip(tl.uada_loss(tlg, tlab, ce_t, cfg_t, 3.0, add), jl.uada_loss(jlg, jlab, ce_j, cfg_j, 3.0, add)):
            _close(g, w)
    for g, w in zip(tl.upa_loss(tlg, tlab, ce_t, cfg_t, 0.7, 0.3), jl.upa_loss(jlg, jlab, ce_j, cfg_j, 0.7, 0.3)):
        _close(g, w)
    for obj in ("tma", "uada", "upa"):
        got = tl.per_example_metrics(tlg, tlab, cfg_t, obj, 5.0)
        want = jl.per_example_metrics(jlg, jlab, cfg_j, obj, 5.0)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])

    preds, gt, mask = tl.action_preds_and_mask(tlg, tlab, cfg_t)
    jp, jg, jm = jl.action_preds_and_mask(jlg, jlab, cfg_j)
    for g, w in zip((preds, gt, mask), (jp, jg, jm)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    from roboticattack_torch.utils.action_tokenizer import decode_tokens

    pa, ga = decode_tokens(preds), decode_tokens(torch.where(mask, gt, torch.full_like(gt, 31872)))
    rd = tl.per_dim_relative_distance(pa, ga, mask, maskidx)
    jrd = jl.per_dim_relative_distance(jnp.asarray(pa.numpy()), jnp.asarray(ga.numpy()), jm, maskidx)
    assert sorted(rd) == sorted(jrd)
    for k in jrd:
        _close(rd[k], jrd[k])
    _close(tl.relative_distance_target(pa, ga, mask),
           jl.relative_distance_target(jnp.asarray(pa.numpy()), jnp.asarray(ga.numpy()), jm))
    got_c, want_c = tl.gripper_asr_counts(preds, gt, mask), jl.gripper_asr_counts(jp, jg, jm)
    assert {k: int(v) for k, v in got_c.items()} == {k: int(v) for k, v in want_c.items()}


def test_cosine_similarity_and_clip_match_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 3)).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)
    x[0] = 0.0
    y[1] = 1e-12
    _close(tl.cosine_similarity(_t(x), _t(y)), jl.cosine_similarity(jnp.asarray(x), jnp.asarray(y)))
    g = rng.standard_normal((10, 10, 3)).astype(np.float32) * 1e-4
    for max_norm in (1e-3, 1e3):
        _close(tl.clip_grad_l1(_t(g), max_norm), jl.clip_grad_l1(jnp.asarray(g), max_norm))


# ------------------------------------------------------------------ optimizer
def test_adamw_and_pgd_match_jax():
    rng = np.random.default_rng(13)
    patch = rng.uniform(size=(10, 10, 3)).astype(np.float32)
    tstate, jstate = topt.adam_init(_t(patch)), jopt.adam_init(jnp.asarray(patch))
    tp, jp = _t(patch), jnp.asarray(patch)
    for i in range(5):
        g = (rng.standard_normal(patch.shape) * 10.0 ** -(i + 3)).astype(np.float32)
        lr = 2e-3 * (i + 1)
        tp, tstate = topt.adamw_update(_t(g), tstate, tp, torch.tensor(lr, dtype=torch.float32))
        jp, jstate = jopt.adamw_update(jnp.asarray(g), jstate, jp, jnp.float32(lr))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.m.numpy(), np.asarray(jstate.m), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), rtol=1e-6, atol=1e-18)
        assert int(tstate.count) == int(jstate.count) == i + 1
    np.testing.assert_array_equal(topt.pgd_update(_t(g), _t(patch), 2e-3).numpy(),
                                  np.asarray(jopt.pgd_update(jnp.asarray(g), jnp.asarray(patch), 2e-3)))


def test_cosine_schedule_matches_jax():
    for warmup, total in ((20, 100), (0, 3), (5, 5)):
        for step in range(total + 2):
            assert topt.cosine_schedule_with_warmup(step, 2e-3, warmup, total) == \
                jopt.cosine_schedule_with_warmup(step, 2e-3, warmup, total)


# ------------------------------------------------------------------ forwards
@pytest.mark.parametrize("impl,remat", [("flash", False), ("flash", True), ("chunked", False), ("xla", True)])
def test_llama_apply_matches_jax(jax_params, impl, remat):
    """S = 128 with attn_chunk 64, so JAX's "chunked" runs two query blocks
    (the port's plain `mha` runs whole rows under "chunked" and "xla")."""
    rng = np.random.default_rng(14)
    emb = rng.standard_normal((2, 128, VLA_TINY.llm.hidden_size)).astype(np.float32) * 0.5
    mask = np.ones((2, 128), np.int32)
    mask[1, 100:] = 0
    jcfg = with_impl(VLA_TINY, impl).llm
    tcfg = with_impl(T_TINY, impl).llm
    want = jllama.llama_apply(jax_params["llm"], jcfg, jnp.asarray(emb), jnp.asarray(mask),
                              remat=remat, logits_tail=40)
    p_llm = params_from_jax(jax_params["llm"])
    temb = _t(emb).requires_grad_(True)
    got = tllama.llama_apply(p_llm, tcfg, temb, _t(mask), remat=remat, logits_tail=40)
    _close(got, want, FWD_TOL)
    # the input gradient flows (through B2's plain version for flash)
    got.square().mean().backward()
    jgrad = jax.grad(lambda e: jnp.mean(jllama.llama_apply(
        jax_params["llm"], jcfg, e, jnp.asarray(mask), remat=remat, logits_tail=40) ** 2))(jnp.asarray(emb))
    _close(temb.grad, jgrad, dict(rtol=1e-4, atol=1e-7))


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_vla_forward_logits_and_ce_match_jax(jax_params, batch, impl):
    jcfg, tcfg = with_impl(VLA_TINY, impl, remat=True), with_impl(T_TINY, impl, remat=True)
    pixels = np.asarray(jdual(jnp.asarray(batch.images)))
    want = jvlm.vla_forward(jax_params, jcfg, jnp.asarray(batch.input_ids), jnp.asarray(batch.attention_mask),
                            jnp.asarray(pixels), jnp.asarray(batch.labels))
    params = params_from_jax(jax_params)
    got = tvlm.vla_forward(params, tcfg, _t(batch.input_ids).long(), _t(batch.attention_mask).long(),
                           _t(pixels), _t(batch.labels).long())
    assert got.logits.shape == want.logits.shape
    _close(got.logits, want.logits, FWD_TOL)
    _close(got.loss, want.loss, FWD_TOL)
    # the language-only branch (no pixels): full-row logits, no loss
    lang = tvlm.vla_forward(params, tcfg, _t(batch.input_ids).long(), _t(batch.attention_mask).long(), None)
    jlang = jvlm.vla_forward(jax_params, jcfg, jnp.asarray(batch.input_ids),
                             jnp.asarray(batch.attention_mask), None)
    assert lang.loss is None
    _close(lang.logits, jlang.logits, FWD_TOL)
