"""The port's single-device serving options of the decode against the JAX
package on VLA_TINY (fp32, CPU), weights shared through the bridge: the int8
and packed-int4 KV caches, visual-token pruning, the w8a8 prefill and the
Jacobi draft tail, each alone and composed.

Tolerances: the quantizers and the int8 product are held bit-exact (same
values, same f32 scales); the quantized-cache attentions to 1e-5 in float32
(the same math summed in another order) and, in bfloat16, to 2^-7 of the
largest output (a couple of bf16 ulps: both sides round the probabilities
and the output once). Whole decodes are held to equal tokens and actions
(and equal verify passes on the Jacobi tail); the int4-weight cases use the
exact-grid construction of test_decode_quant.py, the JAX Pallas kernel runs
interpreted and the port's wrapper its plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.models import VLA_TINY
from roboticattack_tpu.models import decode as jdec
from roboticattack_tpu.models.quant import _pack_nibbles as j_pack
from roboticattack_tpu.models.quant import quantize_decode_params as j_quantize
from roboticattack_torch.models import decode as tdec
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.models.quant import _pack_nibbles as t_pack
from roboticattack_torch.models.quant import quantize_decode_params as t_quantize
from roboticattack_torch.ops.q4_matmul import q4_matmul, reset_launches

from test_decode import _prompt
from test_decode_quant import _cooked_tiny, _grid_pair_int4

NUM_PATCHES = (VLA_TINY.dino.image_size // VLA_TINY.dino.patch_size) ** 2


@pytest.fixture(scope="module")
def cooked():
    return _cooked_tiny(seed=3)


@pytest.fixture(scope="module")
def weights(cooked):
    """The weight sets the decodes run on, as numpy pytrees."""
    return {"bf": cooked, "int8": j_quantize(cooked, xp=np, mode="int8"),
            "int4": _grid_pair_int4(cooked)[1]}


@pytest.fixture(scope="module")
def inputs():
    ids, mask, px = _prompt(batch=2, seed=4)
    return ids, mask, np.array(px)


def _jax(params_np, inputs, **kw):
    ids, mask, px = inputs
    if kw.get("draft_tokens") is not None:
        kw["draft_tokens"] = jnp.asarray(kw["draft_tokens"])
    return jdec.greedy_decode_actions(
        jax.tree.map(jnp.asarray, params_np), VLA_TINY, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(px), cooked_weights=True, **kw)


def _torch(params_np, inputs, **kw):
    ids, mask, px = inputs
    if kw.get("draft_tokens") is not None:
        kw["draft_tokens"] = torch.tensor(np.asarray(kw["draft_tokens"]), dtype=torch.int32)
    with torch.inference_mode():
        return tdec.greedy_decode_actions(
            params_from_jax(params_np), T_TINY, torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(px), cooked_weights=True, **kw)


@pytest.fixture(scope="module")
def seq_tokens(weights, inputs):
    """The JAX sequential tokens a draft is made from, by weight set."""
    return {
        "bf": np.asarray(_jax(weights["bf"], inputs).tokens),
        "int4_kv4": np.asarray(_jax(weights["int4"], inputs, kv_cache="int4", int4_kernel=True).tokens),
    }


# ----------------------------------------------------------------- helpers
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_kv_matches_jax(qmax):
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 16)).astype(np.float32)
    want_q, want_s = jdec._quantize_kv(jnp.asarray(x), qmax, jnp.int8)
    got_q, got_s = tdec._quantize_kv(torch.from_numpy(x), qmax)
    assert got_q.dtype == torch.int8 and got_s.shape == (2, 3, 5)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_k4_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 16)).astype(np.float32)
    gs = tdec._kv4_group_size(16)
    assert gs == jdec._kv4_group_size(16) == 8 and tdec._kv4_group_size(128) == 32
    want_q, want_s = jdec._quantize_k4(jnp.asarray(x), gs)
    got_q, got_s = tdec._quantize_k4(torch.from_numpy(x), gs)
    assert got_s.shape == (2, 3, 5, 2)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q, np.int8))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_packed_int4_cache_round_trip_is_exact():
    """Every pair of s4 values packs to one byte (the JAX package's nibble
    convention) and unpacks to itself; the cache's bytes are half the int8
    cache's."""
    vals = np.array([(a, b) for a in range(-8, 8) for b in range(-8, 8)], np.int8).reshape(1, 1, 256, 2)
    packed = t_pack(torch.from_numpy(vals))
    np.testing.assert_array_equal(packed.numpy(), j_pack(vals, np))
    np.testing.assert_array_equal(tdec._unpack_s4(packed).numpy(), vals)
    sizes = {m: {k: np.prod(s) * torch.empty((), dtype=dt).element_size()
                 for k, (s, dt) in tdec.kv_cache_shapes(T_TINY.llm, 2, 40, m, torch.float32).items()}
             for m in ("int8", "int4")}
    assert sizes["int4"]["k"] * 2 == sizes["int8"]["k"] and sizes["int4"]["v"] * 2 == sizes["int8"]["v"]


def _attend_inputs(kind, dtype, seed=1):
    rng = np.random.default_rng(seed)
    b, h, t, hd, g = 2, 3, 6, 16, 2
    q = rng.standard_normal((b, h, 2, hd)).astype(np.float32)
    lim = 127 if kind == "kv8" else 7
    k = rng.integers(-lim, lim + 1, (b, h, t, hd)).astype(np.int8)
    v = rng.integers(-lim, lim + 1, (b, h, t, hd)).astype(np.int8)
    sk = np.exp2(rng.uniform(-9, -3, (b, h, t) + ((g,) if kind == "kv4" else ()))).astype(np.float32)
    sv = np.exp2(rng.uniform(-9, -3, (b, h, t))).astype(np.float32)
    bias = np.where(rng.random((b, 1, 2, t)) < 0.8, 0.0, -2.3819763e38).astype(np.float32)
    bias[..., 0] = 0.0  # every query sees a key
    jq = jnp.asarray(q).astype(jnp.dtype(dtype))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    return (jq, k, sk, v, sv, bias), (tq, k, sk, v, sv, bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["kv8", "kv4"])
def test_quantized_cache_attention_matches_jax(kind, dtype):
    (jq, k, sk, v, sv, bias), (tq, *_) = _attend_inputs(kind, dtype)
    if kind == "kv8":
        want = jdec._attend_kv8(jq, jnp.asarray(k), jnp.asarray(sk), jnp.asarray(v),
                                jnp.asarray(sv), jnp.asarray(bias))
        got = tdec._attend_kv8(tq, torch.from_numpy(k), torch.from_numpy(sk), torch.from_numpy(v),
                               torch.from_numpy(sv), torch.from_numpy(bias))
    else:
        want = jdec._attend_kv4(jq, jnp.asarray(k).astype(jnp.int4), jnp.asarray(sk),
                                jnp.asarray(v).astype(jnp.int4), jnp.asarray(sv), jnp.asarray(bias))
        got = tdec._attend_kv4(tq, t_pack(torch.from_numpy(k)), torch.from_numpy(sk),
                               t_pack(torch.from_numpy(v)), torch.from_numpy(sv), torch.from_numpy(bias))
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 3, 2, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_w8a8_quantize_and_product_match_jax():
    """_quantize_act bit-exact; the int8 x int8 -> int32 product exact; the
    dequantized projection bit-equal to the JAX `_proj(act8=True)`."""
    rng = np.random.default_rng(11)
    y = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w8 = rng.integers(-127, 128, (24, 32)).astype(np.int8)
    scale = (rng.random(24) * 1e-2 + 1e-3).astype(np.float32)
    want_q, want_s = jdec._quantize_act(jnp.asarray(y))
    got_q, got_s = tdec._quantize_act(torch.from_numpy(y))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    prod = tdec._int8_matmul(got_q, torch.from_numpy(w8))
    np.testing.assert_array_equal(prod.numpy(), got_q.numpy().astype(np.int64) @ w8.T.astype(np.int64))
    want = jdec._proj(jnp.asarray(y), jnp.asarray(w8), cooked=True, scale=jnp.asarray(scale), act8=True)
    got = tdec._proj(torch.from_numpy(y), torch.from_numpy(w8), True, torch.from_numpy(scale), act8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- decodes
def _draft(seq_tokens, which, kind):
    ref = seq_tokens[which]
    if kind == "zero":
        return np.zeros_like(ref)
    if kind == "correct":
        return ref
    half = ref.copy()
    half[:, ref.shape[1] // 2:] = 0
    return half


# (id, weight set, options, draft: None or (sequential tokens, kind))
CASES = [
    ("kv8", "bf", dict(kv_cache="int8"), None),
    ("kv4", "bf", dict(kv_cache="int4"), None),
    ("vt_all", "bf", dict(visual_tokens=NUM_PATCHES), None),
    ("vt_half", "bf", dict(visual_tokens=NUM_PATCHES // 2), None),
    ("w8a8", "int8", dict(act_quant="int8"), None),
    ("jacobi_zero", "bf", {}, ("bf", "zero")),
    ("jacobi_correct", "bf", {}, ("bf", "correct")),
    ("jacobi_half", "bf", {}, ("bf", "half")),
    ("kv8_jacobi_zero", "bf", dict(kv_cache="int8"), ("bf", "zero")),
    ("kv4_int4_kernel_jacobi_zero", "int4", dict(kv_cache="int4", int4_kernel=True), ("int4_kv4", "zero")),
    ("kv4_int4_kernel_jacobi_correct", "int4", dict(kv_cache="int4", int4_kernel=True),
     ("int4_kv4", "correct")),
    ("every_lever", "int8", dict(act_quant="int8", kv_cache="int8", visual_tokens=8), ("bf", "zero")),
]


@pytest.mark.parametrize("name,wset,opts,draft", CASES, ids=[c[0] for c in CASES])
def test_decode_option_matches_jax(weights, inputs, seq_tokens, name, wset, opts, draft):
    kw = dict(opts)
    if draft is not None:
        kw["draft_tokens"] = _draft(seq_tokens, *draft)
    reset_launches()
    want = _jax(weights[wset], inputs, **dict(kw))
    got = _torch(weights[wset], inputs, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.actions.numpy(), np.asarray(want.actions))
    assert q4_matmul.launches == {"grouped": 0, "dense": 0}  # CPU: the plain version
    if draft is None:
        assert got.verify_passes is None and want.verify_passes is None
        assert got.logits.shape == (2, 7, VLA_TINY.llm.vocab_size)
    else:
        assert got.verify_passes == int(want.verify_passes)
        assert 1 <= got.verify_passes <= 6 and got.logits is None
        if draft[1] == "correct":
            assert got.verify_passes == 1
            np.testing.assert_array_equal(got.tokens.numpy(), seq_tokens[draft[0]])


@pytest.mark.parametrize("kv_cache", ["int8", "int4"])
def test_quantized_cache_keeps_the_first_token(weights, inputs, kv_cache):
    """The prefill attends over the live full-precision K/V, so the prefill
    logits (and the first token) equal the model-dtype cache's bit for bit."""
    ref = _torch(weights["bf"], inputs)
    got = _torch(weights["bf"], inputs, kv_cache=kv_cache)
    assert torch.equal(got.logits[:, 0], ref.logits[:, 0])
    np.testing.assert_array_equal(got.tokens[:, 0].numpy(), ref.tokens[:, 0].numpy())


def test_keep_all_visual_tokens_is_the_identity(weights, inputs):
    ref = _torch(weights["bf"], inputs)
    got = _torch(weights["bf"], inputs, visual_tokens=NUM_PATCHES)
    assert torch.equal(got.logits, ref.logits) and torch.equal(got.tokens, ref.tokens)


def test_jacobi_with_one_step_runs_no_pass(weights, inputs):
    """num_steps=1: the draft's position 0 is the prefill argmax, 0 passes."""
    ids, mask, px = inputs
    got = _torch(weights["bf"], inputs, num_steps=1, draft_tokens=np.zeros((2, 1), np.int32))
    ref = _torch(weights["bf"], inputs, num_steps=1)
    assert got.verify_passes == 0
    assert torch.equal(got.tokens, ref.tokens)


# ------------------------------------------------------------------ guards
def _raises(weights, inputs, wset, match, **kw):
    with pytest.raises(ValueError, match=match):
        _torch(weights[wset], inputs, **kw)


def test_unknown_kv_cache_raises(weights, inputs):
    _raises(weights, inputs, "bf", "kv_cache", kv_cache="fp8")


@pytest.mark.parametrize("k", [0, -3, 10_000])
def test_visual_tokens_out_of_range_raises(weights, inputs, k):
    _raises(weights, inputs, "bf", "visual_tokens", visual_tokens=k)


@pytest.mark.parametrize("wset", ["int4", "bf"])
def test_w8a8_needs_int8_weights(weights, inputs, wset):
    _raises(weights, inputs, wset, "w8a8", act_quant="int8")


def test_unknown_act_quant_raises(weights, inputs):
    _raises(weights, inputs, "int8", "act_quant", act_quant="int4")


def test_bad_draft_shape_raises(weights, inputs):
    _raises(weights, inputs, "bf", "draft_tokens", draft_tokens=np.zeros((2, 3), np.int32))


@pytest.mark.parametrize("bad", [-1, T_TINY.llm.vocab_size])
def test_draft_ids_outside_the_vocabulary_raise(weights, inputs, bad):
    """An id past the embedding would be an out-of-bounds gather (a sticky
    device-side assert on the card): refused before the prefill."""
    draft = np.zeros((len(inputs[0]), 7), np.int32)
    draft[-1, 3] = bad
    _raises(weights, inputs, "bf", "outside", draft_tokens=draft)


def test_quantize_of_the_port_feeds_w8a8(cooked, inputs):
    """The port's own int8 quantization (bit-equal to the JAX one) runs the
    w8a8 prefill: the int8 x int8 path, not the weight-only one."""
    ids, mask, px = inputs
    q8 = t_quantize(params_from_jax(cooked), mode="int8")
    with torch.inference_mode():
        w8a8 = tdec.greedy_decode_actions(q8, T_TINY, torch.from_numpy(ids), torch.from_numpy(mask),
                                          torch.from_numpy(px), cooked_weights=True, act_quant="int8")
        w8 = tdec.greedy_decode_actions(q8, T_TINY, torch.from_numpy(ids), torch.from_numpy(mask),
                                        torch.from_numpy(px), cooked_weights=True)
    assert torch.isfinite(w8a8.actions).all()
    assert not torch.equal(w8a8.logits[:, 0], w8.logits[:, 0])  # activations were rounded
