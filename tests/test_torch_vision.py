"""The port's vision path against the JAX package on VLA_TINY (fp32, CPU):
dual normalization, both ViT towers, the fused features + projector, the
Llama helpers the decode uses, and the weight bridge.

Tolerance: fp32 on both sides with the same operation order per op; the
only differences are in how XLA and PyTorch's CPU kernels order the sums
inside a matmul and evaluate erf/exp/rsqrt, a few f32 ulps per op
compounded over the blocks — rtol 1e-4 and atol 1e-5 hold that with
room, while any layout or formula slip shows up as O(1) error."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.models import llama as jllama
from roboticattack_tpu.models import vit as jvit
from roboticattack_tpu.models import vlm as jvlm
from roboticattack_tpu.utils.normalization import dual_normalize as jdual
from roboticattack_torch.models import llama as tllama
from roboticattack_torch.models import vit as tvit
from roboticattack_torch.models import vlm as tvlm
from roboticattack_torch.models.bridge import params_from_jax, tensor_from_numpy
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.utils.normalization import dual_normalize as tdual

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def params():
    return jax.device_get(init_vla_params(jax.random.key(7), VLA_TINY))


def _pixels(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (batch, 56, 56, 3)).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dual_normalize_matches():
    img = _pixels()
    got = tdual(torch.from_numpy(img))
    assert got.shape == (2, 2, 56, 56, 3)
    _close(got, jdual(jnp.asarray(img)))


@pytest.mark.parametrize("tower", ["dino", "siglip"])
def test_vit_features_match(params, tower):
    cfg = getattr(VLA_TINY, tower)
    px = np.array(jdual(jnp.asarray(_pixels(seed=1))))[:, 0 if tower == "dino" else 1]
    want = jvit.vit_features(jax.tree.map(jnp.asarray, params["vision"][tower]), cfg, jnp.asarray(px))
    tower_params = params_from_jax(params["vision"][tower])
    got = tvit.vit_features(tower_params, getattr(T_TINY, tower), torch.from_numpy(px))
    assert got.shape == (2, cfg.num_patches, cfg.embed_dim)
    _close(got, want)


def test_vision_features_and_projector_match(params):
    px = np.array(jdual(jnp.asarray(_pixels(seed=2))))
    jp = jax.tree.map(jnp.asarray, params)
    want = jvlm.projector_apply(jp["projector"], jvlm.vision_features(jp["vision"], VLA_TINY, jnp.asarray(px)))
    model = params_from_jax(params, "cpu", T_TINY)
    got = model(torch.from_numpy(px))
    assert got.shape == (2, VLA_TINY.num_patches, VLA_TINY.llm.hidden_size)
    _close(got, want)


def test_layer_norm_rms_norm_and_rope_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tvit.layer_norm(*map(torch.from_numpy, (x, s, bias)), 1e-6),
           jvit.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias), 1e-6))
    _close(tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jllama.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    pos = np.arange(9)
    cos_t, sin_t = tllama.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    cos_j, sin_j = jllama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    q = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    qt, kt = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos_t, sin_t)
    qj, kj = jllama.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    _close(qt, qj)
    _close(kt, kj)


def test_bridge_keeps_names_shapes_and_bf16_bits(params):
    """Every JAX leaf lands under its dotted pytree path with its shape;
    bf16 leaves (ml_dtypes numpy arrays) cross bit-identically."""
    model = params_from_jax(params, "cpu", T_TINY)
    named = dict(model.named_parameters())
    flat = {
        ".".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    assert set(named) == set(flat)
    assert "llm.layers.q_w" in named and "vision.dino.blocks.qkv_w" in named
    for name, leaf in flat.items():
        assert tuple(named[name].shape) == leaf.shape, name

    bf = np.asarray(jnp.asarray(params["llm"]["lm_head"], jnp.bfloat16))
    t = tensor_from_numpy(bf)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), bf.view(np.int16))


def test_port_init_matches_jax_shapes_and_dtypes(params):
    """The port's random init draws other numbers than jax.random, but must
    build the same pytree: same keys, shapes and dtypes."""
    gen = torch.Generator().manual_seed(0)
    mine = tvlm.init_vla_params(gen, T_TINY)
    flat_mine = {
        ".".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(mine)
    }
    flat_jax = {
        ".".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    assert set(flat_mine) == set(flat_jax)
    for k, leaf in flat_jax.items():
        assert tuple(flat_mine[k].shape) == leaf.shape, k
        assert flat_mine[k].dtype == torch.float32, k
