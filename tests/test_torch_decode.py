"""The port's greedy action decode and decode quantization against the JAX
package on VLA_TINY (fp32, CPU), weights shared through the bridge.

Quantization is held bit-exact (same packed bytes and scales). The decode is
held to equal tokens and actions for quantize None, int8 and int4 (JAX with
the Pallas kernel interpreted, the port with the kernel's plain version);
the int4 case uses the exact-grid construction of test_decode_quant.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.models import VLA_TINY
from roboticattack_tpu.models.decode import ensure_trailing_empty_token as j_ensure
from roboticattack_tpu.models.decode import greedy_decode_actions as j_decode
from roboticattack_tpu.models.decode import unnormalize_actions as j_unnorm
from roboticattack_tpu.models.quant import quantize_decode_params as j_quantize
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.models.decode import decode_layout_params as t_cook
from roboticattack_torch.models.decode import ensure_trailing_empty_token as t_ensure
from roboticattack_torch.models.decode import greedy_decode_actions as t_decode
from roboticattack_torch.models.decode import unnormalize_actions as t_unnorm
from roboticattack_torch.models.quant import QUANT_LAYER_KEYS, quant_mode
from roboticattack_torch.models.quant import quantize_decode_params as t_quantize
from roboticattack_torch.ops.q4_matmul import q4_matmul, reset_launches

from test_decode import _prompt
from test_decode_quant import _cooked_tiny, _grid_pair_int4


@pytest.fixture(scope="module")
def cooked():
    return _cooked_tiny(seed=3)


@pytest.fixture(scope="module")
def inputs():
    ids, mask, px = _prompt(batch=2, seed=4)
    return ids, mask, np.array(px)


def _pair(params_np, inputs, int4_kernel=False):
    """(JAX result, port result) of the cooked decode on the same inputs."""
    ids, mask, px = inputs
    want = j_decode(
        jax.tree.map(jnp.asarray, params_np), VLA_TINY, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(px), cooked_weights=True,
        int4_kernel=int4_kernel,
    )
    with torch.inference_mode():
        got = t_decode(
            params_from_jax(params_np), T_TINY, torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(px), cooked_weights=True,
            int4_kernel=int4_kernel,
        )
    return want, got


@pytest.mark.parametrize("mode,gs", [("int8", 128), ("int4", 16), ("int4", 64)])
def test_quantize_decode_params_bit_exact(cooked, mode, gs):
    """Packed bytes and scales equal the JAX package's exactly."""
    want = j_quantize(cooked, xp=np, mode=mode, group_size=gs)
    got = t_quantize(params_from_jax(cooked), mode=mode, group_size=gs)
    assert quant_mode(got) == mode
    for k in QUANT_LAYER_KEYS:
        for leaf in (k, k + "_scale"):
            np.testing.assert_array_equal(got["llm"]["layers"][leaf].numpy(),
                                          np.asarray(want["llm"]["layers"][leaf]), leaf)
    for leaf in ("lm_head", "lm_head_scale", "embed", "embed_scale"):
        np.testing.assert_array_equal(got["llm"][leaf].numpy(), np.asarray(want["llm"][leaf]), leaf)
    # the untouched leaves stay the very same tensors' values
    np.testing.assert_array_equal(got["llm"]["norm"].numpy(), np.asarray(cooked["llm"]["norm"]))


def test_quantized_module_holds_stacks_as_buffers(cooked):
    """In the VLA module, quantized stacks and their scales are buffers under
    the JAX names; float weights (the ViT's LayerNorm `ln1_scale` included)
    stay parameters."""
    from roboticattack_torch.models.vlm import VLA

    model = VLA(T_TINY, t_quantize(params_from_jax(cooked), mode="int4", group_size=64))
    buffers, params = dict(model.named_buffers()), dict(model.named_parameters())
    for k in QUANT_LAYER_KEYS:
        assert buffers[f"llm.layers.{k}"].dtype == torch.int8
        assert buffers[f"llm.layers.{k}_scale"].dtype == torch.float32
    assert {"llm.lm_head", "llm.lm_head_scale", "llm.embed", "llm.embed_scale"} <= set(buffers)
    assert "vision.dino.blocks.ln1_scale" in params and "llm.norm" in params
    assert quant_mode(model.tree()) == "int4"


def test_decode_layout_params_matches(cooked):
    """Cooking in the port equals the JAX cooking (the [L, out, in] stacks)."""
    from roboticattack_tpu.models import init_vla_params

    storage = jax.device_get(init_vla_params(jax.random.key(3), VLA_TINY))
    got = t_cook(params_from_jax(storage))
    for k in ("q_w", "gate_w", "down_w"):
        np.testing.assert_array_equal(got["llm"]["layers"][k].numpy(),
                                      np.asarray(cooked["llm"]["layers"][k]))


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_greedy_decode_matches_jax(cooked, inputs, quantize):
    if quantize is None:
        params = cooked
    elif quantize == "int8":
        params = j_quantize(cooked, xp=np, mode="int8")
    else:
        params = _grid_pair_int4(cooked)[1]
    want, got = _pair(params, inputs, int4_kernel=quantize == "int4")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.actions.numpy(), np.asarray(want.actions))
    assert got.logits.shape == (2, 7, VLA_TINY.llm.vocab_size)
    assert got.tokens.dtype == torch.int32


def test_int4_plain_tail_matches_jax(cooked, inputs):
    """int4 without the kernel: the XLA formulation's port (dequantized
    nibble halves in the model dtype) gives the JAX tokens too."""
    want, got = _pair(_grid_pair_int4(cooked)[1], inputs, int4_kernel=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_decode_on_cpu_launches_no_kernel(cooked, inputs):
    """int4_kernel=True on CPU tensors routes through the wrapper, which
    takes the plain version: the launch counters stay at 0."""
    reset_launches()
    _, got = _pair(_grid_pair_int4(cooked)[1], inputs, int4_kernel=True)
    assert got.tokens.shape == (2, 7)
    assert q4_matmul.launches == {"grouped": 0, "dense": 0}


@pytest.mark.parametrize("kwarg,value", [
    ("mesh", object()),
])
def test_unported_options_raise(cooked, inputs, kwarg, value):
    """`mesh` is ported (test_torch_tp_serving.py); what is not a
    ServingMesh is refused."""
    ids, mask, px = inputs
    with pytest.raises(TypeError, match="ServingMesh"):
        t_decode(params_from_jax(cooked), T_TINY, torch.from_numpy(ids),
                 torch.from_numpy(mask), torch.from_numpy(px),
                 cooked_weights=True, **{kwarg: value})


def test_decode_guards_cooked_flag(cooked, inputs):
    ids, mask, px = inputs
    q = t_quantize(params_from_jax(cooked), mode="int8")
    with pytest.raises(ValueError, match="cooked_weights=True"):
        t_decode(q, T_TINY, torch.from_numpy(ids), torch.from_numpy(mask),
                 torch.from_numpy(px), cooked_weights=False)
    with pytest.raises(ValueError, match="cooked_weights=False"):
        t_decode(params_from_jax(cooked), T_TINY, torch.from_numpy(ids),
                 torch.from_numpy(mask), torch.from_numpy(px), cooked_weights=False)


def test_host_helpers_match():
    ids = np.array([[1, 5, 6, 32000], [1, 5, 29871, 32000]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], np.int32)
    for a, b in zip(t_ensure(ids, mask), j_ensure(ids, mask)):
        np.testing.assert_array_equal(a, b)
    stats = {"k": {"action": {"q01": [-0.1] * 7, "q99": [0.3] * 7,
                              "mask": [True] * 6 + [False]}}}
    acts = np.linspace(-1, 1, 14).reshape(2, 7)
    np.testing.assert_array_equal(t_unnorm(acts, stats), j_unnorm(acts, stats))
