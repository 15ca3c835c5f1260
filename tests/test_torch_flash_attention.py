"""The port's attention kernels' plain versions (B1/B2 on a CPU tensor)
against the JAX package's Pallas kernels run in interpret mode, the
autograd Function's gradients against `jax.grad` through the Pallas VJP,
the plain chunked attention, and the wrapper's refusals.

Tolerances: fp32 on both sides with the same operation order; the matmul
sums differ in order between XLA and PyTorch (a few f32 ulps), so 2e-5 for
values and 3e-5 for gradients (the JAX package's own flash tests); bf16
outputs 2e-2 (one bf16 ulp near 1 is 2^-8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.ops import attention as jattn
from roboticattack_tpu.ops.flash_attention import mha_flash as jmha_flash
from roboticattack_torch.ops import attention as tattn
from roboticattack_torch.ops.flash_attention import (
    _probs,
    check_kernel_inputs,
    flash_attention,
    flash_attention_bwd_plain,
    mha_flash,
)


def _inputs(b, h, s, d, seed, pad=0, with_bias=True):
    """numpy q/k/v/dO [B, H, S, D] and the JAX causal + padding bias
    [B, 1, S, S] (the last `pad` keys of the last row are padding)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    if not with_bias:
        return q, k, v, do, None
    mask = np.ones((b, s), np.int32)
    if pad:
        mask[b - 1, s - pad:] = 0
    bias = np.array(jattn.causal_bias(s, s) + jattn.padding_bias(jnp.asarray(mask)))
    return q, k, v, do, bias


CASES = [  # b, h, s, d, pad, with_bias
    (2, 4, 64, 32, 7, True),
    (1, 2, 48, 16, 5, True),
    (2, 2, 33, 16, 0, True),    # S not a multiple of anything
    (1, 3, 20, 16, 0, False),   # bias=None -> zeros
]


@pytest.mark.parametrize("b,h,s,d,pad,with_bias", CASES)
def test_plain_forward_matches_pallas_interpret(b, h, s, d, pad, with_bias):
    q, k, v, _, bias = _inputs(b, h, s, d, seed=s, pad=pad, with_bias=with_bias)
    jb = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jmha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb, interpret=True))
    tb = None if bias is None else torch.from_numpy(bias)
    got = mha_flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias=tb).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_forward_bf16_matches_pallas_interpret():
    q, k, v, _, bias = _inputs(1, 2, 32, 32, seed=2, pad=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jmha_flash(jq, jk, jv, bias=jnp.asarray(bias), interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = mha_flash(tq, tk, tv, bias=torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,h,s,d,pad,with_bias", CASES)
def test_function_gradients_match_pallas_vjp(b, h, s, d, pad, with_bias):
    """dq/dk/dv of the autograd Function (plain B2 on the CPU) against
    jax.grad through the Pallas custom VJP, for a random output cotangent."""
    q, k, v, do, bias = _inputs(b, h, s, d, seed=100 + s, pad=pad, with_bias=with_bias)
    jb = None if bias is None else jnp.asarray(bias)

    def loss(q_, k_, v_):
        return jnp.sum(jmha_flash(q_, k_, v_, bias=jb, interpret=True) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = mha_flash(tq, tk, tv, bias=None if bias is None else torch.from_numpy(bias))
    out.backward(torch.from_numpy(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=3e-5, atol=3e-5)
    assert flash_attention.launches == {"fwd": 0, "bwd": 0}  # CPU tensors launch nothing


def test_backward_plain_is_the_written_out_pallas_rule():
    """flash_attention_bwd_plain against autograd through the plain mha (the
    same function, differentiated by PyTorch): the written-out rule holds."""
    q, k, v, do, bias = _inputs(2, 2, 40, 16, seed=9, pad=4)
    tb = torch.from_numpy(bias)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tattn.mha(tq, tk, tv, bias=tb).backward(torch.from_numpy(do))
    got = flash_attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), tb[:, 0], torch.from_numpy(do))
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("s,chunk", [(128, 64), (192, 64), (100, 64), (64, 64)])
def test_mha_chunked_matches_jax(s, chunk):
    q, k, v, _, bias = _inputs(2, 2, s, 16, seed=s, pad=6)
    want = np.asarray(jattn.mha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        bias=jnp.asarray(bias), chunk=chunk))
    got = tattn.mha_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            bias=torch.from_numpy(bias), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_causal_and_padding_bias_match_jax():
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(tattn.causal_bias(5, 5).numpy(), np.asarray(jattn.causal_bias(5, 5)))
    np.testing.assert_array_equal(tattn.causal_bias(2, 5).numpy(), np.asarray(jattn.causal_bias(2, 5)))
    np.testing.assert_array_equal(tattn.padding_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jattn.padding_bias(jnp.asarray(mask))))


def test_wrapper_refuses_per_head_bias_and_gqa():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="per-head bias"):
        mha_flash(q, q, q, torch.zeros((1, 4, 8, 8)))
    with pytest.raises(ValueError, match="GQA"):
        mha_flash(q, q[:, :2], q[:, :2])


def _split_operands(s, seed):
    """P and dS as B2 forms them ([1, 2, S, S] f32, from seeded bf16 q/k/v/dO
    [1, 2, S, 128] and a causal bias), and those bf16 operands."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, s, 128)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    bias = tattn.causal_bias(s, s)[:, 0]
    p = _probs(q, k, bias)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return {"P": p, "dS": ds}, {"K": k, "Q": q, "dO": do}


SPLIT_BOUND = 2.0**-15  # csrc/flash_attention.cu: the split alone is within 2^-16


@pytest.mark.parametrize("x_name,b_name,transpose", [
    ("dS", "K", False),   # dQ = dS K      (rows kernel)
    ("dS", "Q", True),    # dK = dS^T Q    (columns kernel)
    ("P", "dO", True),    # dV = P^T dO    (columns kernel)
])
@pytest.mark.parametrize("s", [40, 288])
def test_two_term_bf16_split_error_is_within_the_stated_bound(x_name, b_name, transpose, s):
    """B2's products with an f32 operand x run as hi B + lo B on the tensor
    cores, hi = bf16(x), lo = bf16(x - hi), B bf16, f32 sums. Emulated here:
    each entry is within 2^-15 sum_j |x_j b_j| of the float64 product, and
    the one-term product bf16(x) B is not (the bound separates the two)."""
    xs, bs = _split_operands(s, seed=s)
    x, b = xs[x_name], bs[b_name].float()
    if transpose:
        x = x.transpose(-1, -2)
    hi = x.bfloat16()
    lo = (x - hi.float()).bfloat16()
    assert ((x - hi.float() - lo.float()).abs() <= 2.0**-16 * x.abs()).all()
    got = torch.matmul(hi.float(), b) + torch.matmul(lo.float(), b)
    exact = torch.matmul(x.double(), b.double())
    bound = SPLIT_BOUND * torch.matmul(x.double().abs(), b.double().abs())
    assert ((got.double() - exact).abs() <= bound).all()
    one_term = torch.matmul(hi.float(), b).double()
    assert ((one_term - exact).abs() > bound).any()


@pytest.mark.parametrize("shape,dtype,bias_shape,match", [
    ((1, 2, 8, 64), torch.bfloat16, (1, 8, 8), "head dim 128"),
    ((1, 2, 8, 128), torch.float32, (1, 8, 8), "bf16"),
    ((1, 1, 2049, 128), torch.bfloat16, (1, 2049, 2049), "S <= 2048"),
    ((1, 2, 8, 128), torch.bfloat16, (1, 1, 8, 8), r"bias \[B, S, S\]"),
])
def test_kernel_input_check_names_the_shapes(shape, dtype, bias_shape, match):
    """What the CUDA kernels refuse, checked before any launch (the check is
    the one the CUDA path runs; its message carries the shapes)."""
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match) as err:
        check_kernel_inputs(q, q, q, torch.zeros(bias_shape))
    assert str(tuple(shape)) in str(err.value)
