"""The port's Phi-2 decoder (the phi-2+3b zoo entry) against the JAX
package's on the CPU: `phi_apply` logits, `convert_phi`, `init_phi_params`
shapes, a tiny Phi VLA's loss and pixel gradient through `vla_forward`, and
the refusals (an unknown attention implementation, action decoding), and
`attn_impl="flash"`, which runs B1/B2's plain versions on the CPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.models import init_vla_params as jax_init_vla_params
from roboticattack_tpu.models import vla_forward as jax_vla_forward
from roboticattack_tpu.models.config import PhiConfig as JPhiConfig
from roboticattack_tpu.models.config import VLA_TINY as J_TINY
from roboticattack_tpu.models.phi import convert_phi as jax_convert_phi
from roboticattack_tpu.models.phi import init_phi_params as jax_init_phi_params
from roboticattack_tpu.models.phi import phi_apply as jax_phi_apply
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import PhiConfig, VLA_TINY
from roboticattack_torch.models.decode import greedy_decode_actions
from roboticattack_torch.models.phi import convert_phi, init_phi_params, phi_apply
from roboticattack_torch.models.vlm import VLA, init_vla_params, vla_forward

SMALL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
             max_seq_len=64)
TINY_PHI, J_TINY_PHI = PhiConfig(**SMALL), JPhiConfig(**SMALL)


def _cfgs(**over):
    return PhiConfig(**SMALL, **over), JPhiConfig(**SMALL, **over)


@pytest.fixture(scope="module")
def jax_phi():
    return jax.device_get(jax_init_phi_params(jax.random.key(3), J_TINY_PHI))


@pytest.mark.parametrize("attn_impl,chunk", [("chunked", 64), ("chunked", 4), ("xla", None)])
@pytest.mark.parametrize("masked", [False, True])
def test_phi_apply_matches_jax(jax_phi, attn_impl, chunk, masked):
    """fp32 logits within 1e-5 relative (of the logits' scale), with and
    without a padding mask, against each of JAX's attention paths (its
    query-chunked one at two chunks and its plain one); the port runs its
    plain `mha` under both "chunked" and "xla"."""
    cfg, jcfg = _cfgs(attn_impl=attn_impl, attn_chunk=chunk)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, SMALL["vocab_size"], (2, 12))
    mask = np.ones((2, 12), np.int32)
    if masked:
        mask[1, 9:] = 0
    emb = np.asarray(jax_phi["embed"])[ids]
    want = np.asarray(jax_phi_apply(jax.tree.map(jnp.asarray, jax_phi), jcfg, jnp.asarray(emb),
                                    attention_mask=jnp.asarray(mask) if masked else None))
    params = params_from_jax(jax_phi, "cpu")
    got = phi_apply(params, cfg, torch.from_numpy(emb),
                    attention_mask=torch.from_numpy(mask) if masked else None).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 12, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    tail = phi_apply(params, cfg, torch.from_numpy(emb), logits_tail=4, remat=True).numpy()
    np.testing.assert_allclose(tail, phi_apply(params, cfg, torch.from_numpy(emb)).numpy()[:, -4:],
                               rtol=0, atol=1e-6)


def test_phi_flash_attention_is_refused(jax_phi):
    """An attention implementation the port does not have is refused. Since
    B1/B2 take Phi-2's head sizes, "flash" is not: it runs the kernels'
    plain versions on the CPU and gives the JAX package's "xla" logits."""
    cfg, _ = _cfgs(attn_impl="pallas")
    params = params_from_jax(jax_phi, "cpu")
    with pytest.raises(ValueError, match="attn_impl='pallas' is not supported"):
        phi_apply(params, cfg, torch.zeros(1, 4, SMALL["hidden_size"]))
    cfg, jcfg = _cfgs(attn_impl="xla")
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    emb = np.asarray(jax_phi["embed"])[np.random.default_rng(1).integers(2, SMALL["vocab_size"], (2, 12))]
    want = np.asarray(jax_phi_apply(jax.tree.map(jnp.asarray, jax_phi), jcfg, jnp.asarray(emb),
                                    attention_mask=jnp.asarray(mask)))
    got = phi_apply(params, dataclasses.replace(cfg, attn_impl="flash"), torch.from_numpy(emb),
                    attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_init_phi_params_has_the_jax_layout(jax_phi):
    got = init_phi_params(torch.Generator().manual_seed(0), TINY_PHI)
    want = params_from_jax(jax_phi, "cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                for k, v in tree.items()}

    assert shapes(got) == shapes(want)
    assert torch.equal(got["layers"]["ln_scale"], torch.ones(2, 32))
    assert float(got["layers"]["q_w"].std()) == pytest.approx(0.02, rel=0.2)


def test_convert_phi_matches_jax_on_an_hf_phi():
    """HF `PhiForCausalLM` state names -> both converters give the same
    tree, bit for bit, and the port's forward matches HF's logits."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.PhiConfig(
        vocab_size=SMALL["vocab_size"], hidden_size=SMALL["hidden_size"],
        num_hidden_layers=SMALL["num_layers"], num_attention_heads=SMALL["num_heads"],
        num_key_value_heads=SMALL["num_heads"], intermediate_size=SMALL["intermediate_size"],
        partial_rotary_factor=TINY_PHI.partial_rotary_factor, rope_theta=TINY_PHI.rope_theta,
        layer_norm_eps=TINY_PHI.ln_eps, hidden_act="gelu_new",
        max_position_embeddings=SMALL["max_seq_len"], attention_dropout=0.0, embd_pdrop=0.0,
        resid_pdrop=0.0,
    )
    torch.manual_seed(0)
    model = transformers.PhiForCausalLM(hf_cfg).eval()
    state = {"language_model." + k: v.detach().clone() for k, v in model.state_dict().items()}
    got = convert_phi(state, TINY_PHI, device="cpu")
    want = params_from_jax(jax_convert_phi({k: v.numpy() for k, v in state.items()}, J_TINY_PHI))
    flat_g = dict(torch.utils._pytree.tree_flatten_with_path(got)[0])
    for path, w in torch.utils._pytree.tree_flatten_with_path(want)[0]:
        assert flat_g[path].dtype == w.dtype and torch.equal(flat_g[path], w), path

    ids = torch.from_numpy(np.random.default_rng(1).integers(2, SMALL["vocab_size"], (2, 9)))
    with torch.no_grad():
        hf = model(ids).logits
    mine = phi_apply(got, TINY_PHI, got["embed"][ids])
    np.testing.assert_allclose(mine.numpy(), hf.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_tiny_phi_vla_loss_and_pixel_gradient_match_jax(remat):
    """A VLA_TINY over the tiny Phi: vla_forward's loss and its gradient
    with respect to the pixels within 1e-4 of JAX's; the unimodal branch
    too."""
    jcfg = dataclasses.replace(J_TINY, name="tiny-phi", llm=J_TINY_PHI, remat=remat)
    cfg = dataclasses.replace(VLA_TINY, name="tiny-phi", llm=TINY_PHI, remat=remat)
    jparams = jax.device_get(jax_init_vla_params(jax.random.key(4), jcfg))
    params = params_from_jax(jparams, "cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 120, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 8:] = 0
    labels = np.where(rng.random((2, 10)) < 0.6, ids, -100)
    labels[:, 0] = -100
    pixels = rng.standard_normal((2, 2, 56, 56, 3)).astype(np.float32)

    def jloss(px):
        return jax_vla_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), px,
                               jnp.asarray(labels)).loss

    want_loss, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pixels))
    px = torch.from_numpy(pixels).requires_grad_()
    out = vla_forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask), px,
                      torch.from_numpy(labels))
    out.loss.backward()
    assert abs(out.loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(px.grad.numpy(), want_grad, rtol=0,
                               atol=1e-4 * np.abs(want_grad).max())
    assert np.abs(want_grad).max() > 0

    uni = vla_forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask), None,
                      torch.from_numpy(labels))
    juni = jax_vla_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), None,
                           jnp.asarray(labels))
    assert abs(uni.loss.item() - float(juni.loss)) <= 1e-4 * abs(float(juni.loss))


def test_phi_vla_module_and_init():
    """init_vla_params draws a Phi LLM for a Phi config; the VLA module
    holds it under the JAX names; the action decode refuses it."""
    cfg = dataclasses.replace(VLA_TINY, name="tiny-phi", llm=TINY_PHI)
    params = init_vla_params(torch.Generator().manual_seed(1), cfg)
    assert set(params["llm"]["lm_head"]) == {"w", "b"}
    names = {n for n, _ in VLA(cfg, params).named_parameters()}
    assert {"llm.lm_head.w", "llm.lm_head.b", "llm.norm.scale", "llm.layers.fc1_w"} <= names
    with pytest.raises(NotImplementedError, match="Phi-2"):
        greedy_decode_actions(params, cfg, torch.zeros(1, 4, dtype=torch.int64),
                              torch.ones(1, 4, dtype=torch.int64), torch.zeros(1, 2, 56, 56, 3))
