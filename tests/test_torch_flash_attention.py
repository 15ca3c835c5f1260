"""The port's attention kernels' plain versions (B1/B2 on a CPU tensor)
against the JAX package's Pallas kernels run in interpret mode, the
autograd Function's gradients against `jax.grad` through the Pallas VJP and
against plain attention under autograd (head dims 64/72/80/128, grouped
key/value heads, with and without a bias), the plain chunked attention, the
wrapper's refusals, the dispatch's choice between kernels and plain
attention, and the kernel counter.

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
from torch.profiler import ProfilerActivity, profile

from roboticattack_torch.ops import attention as tattn
from roboticattack_torch.ops import flash_attention as fa
from roboticattack_torch.ops.flash_attention import (
    _probs,
    check_kernel_inputs,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
    mha_flash,
)
from roboticattack_torch.utils import profiling


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
def test_mha_matches_jax_mha_chunked(s, chunk):
    """The port's one plain path (`mha`, whole rows) against JAX's
    query-chunked attention, which configs with attn_impl "chunked" run."""
    q, k, v, _, bias = _inputs(2, 2, s, 16, seed=s, pad=6)
    want = np.asarray(jattn.mha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        bias=jnp.asarray(bias), chunk=chunk))
    got = tattn.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_causal_and_padding_bias_match_jax():
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(tattn.causal_bias(5, 5).numpy(), np.asarray(jattn.causal_bias(5, 5)))
    np.testing.assert_array_equal(tattn.causal_bias(2, 5).numpy(), np.asarray(jattn.causal_bias(2, 5)))
    np.testing.assert_array_equal(tattn.padding_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jattn.padding_bias(jnp.asarray(mask))))


@pytest.mark.parametrize("case", ["per_head_bias", "gqa"])
def test_wrapper_refuses_per_head_bias_and_gqa(case):
    """A per-head bias is refused; grouped key/value heads (4 query heads
    on 2) are taken and give plain attention's output."""
    q = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 8, 16)).astype(np.float32))
    if case == "per_head_bias":
        with pytest.raises(ValueError, match="per-head bias"):
            mha_flash(q, q, q, torch.zeros((1, 4, 8, 8)))
    else:
        k, v = q[:, :2] * 0.5, q[:, 2:] + 1.0
        np.testing.assert_allclose(mha_flash(q, k, v).numpy(), tattn.mha(q, k, v).numpy(), rtol=2e-5, atol=2e-5)


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
    pytest.param((1, 2, 8, 96), torch.bfloat16, (1, 8, 8), "head dim 64, 72, 80 or 128",
                 id="shape0-dtype0-bias_shape0-head dim 128"),
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


def _grouped_inputs(d, group, with_bias, seed):
    """f32 q [2, 2 group, 24, d], k/v [2, 2, 24, d], dO, and a causal +
    padding bias [2, 1, 24, 24] (the last 5 keys of row 1 padded) or None."""
    rng = np.random.default_rng(seed)
    b, hkv, s = 2, 2, 24
    q, do = (torch.from_numpy(rng.standard_normal((b, hkv * group, s, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s, d)).astype(np.float32)) for _ in range(2))
    if not with_bias:
        return q, k, v, do, None
    mask = torch.ones((b, s), dtype=torch.int32)
    mask[1, s - 5:] = 0
    return q, k, v, do, tattn.causal_bias(s, s) + tattn.padding_bias(mask)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 72, 80, 128])
def test_plain_versions_and_function_match_plain_attention_under_autograd(d, group, with_bias):
    """B1/B2's plain versions, and the autograd Function that runs them on
    the CPU, against ops.attention.mha differentiated by autograd (its
    grouped heads repeated, so dK and dV sum over each group): the kernels'
    every head dim, one and four query heads a key/value head, with and
    without the decoder's causal + padding bias. f32 on both sides: a few
    ulps of the sums' order."""
    q, k, v, do, bias = _grouped_inputs(d, group, with_bias, seed=d + group)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = tattn.mha(*leaves, bias=bias)
    want.backward(do)
    squeezed = None if bias is None else bias[:, 0]
    np.testing.assert_allclose(flash_attention_fwd_plain(q, k, v, squeezed).numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    for got, leaf in zip(flash_attention_bwd_plain(q, k, v, squeezed, do), leaves):
        assert got.shape == leaf.shape
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=3e-5, atol=3e-5)
    through = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = mha_flash(*through, bias=bias)
    out.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), rtol=2e-5, atol=2e-5)
    for got, leaf in zip(through, leaves):
        np.testing.assert_allclose(got.grad.numpy(), leaf.grad.numpy(), rtol=3e-5, atol=3e-5)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself on CUDA, for the dispatch's checks."""

    @property
    def is_cuda(self):
        return True


def _dispatch_inputs(device="cuda", dtype=torch.bfloat16, d=80, hq=8, hkv=2, s=40, bias="full", b=2):
    q = torch.zeros((b, hq, s, d), dtype=dtype)
    k = v = torch.zeros((b, hkv, s, d), dtype=dtype)
    shapes = {"full": (b, 1, s, s), "shared": (1, 1, s, s), "per_head": (b, hq, s, s), "padding": (b, 1, 1, s)}
    t = None if bias is None else torch.zeros(shapes[bias])
    if device == "cuda":
        q, k, v = (x.as_subclass(_OnCuda) for x in (q, k, v))
    return q, k, v, t


@pytest.mark.parametrize("kw,takes", [
    ({}, True),                                   # Phi-2's head dim, GQA, the decoder's bias
    ({"bias": None}, True),                       # a tower: no bias
    ({"bias": "shared"}, True),                   # one [1, 1, S, S] bias for every row
    ({"d": 64, "hq": 16, "hkv": 16, "bias": None}, True),
    ({"d": 72, "hq": 16, "hkv": 16, "bias": None}, True),
    ({"d": 128, "hq": 32, "hkv": 8}, True),
    ({"s": 1}, True),
    ({"s": 2048, "b": 1}, True),
    ({"device": "cpu"}, False),                   # the CPU: plain attention, as the JAX package's tests see it
    ({"dtype": torch.float32}, False),            # float32 configs
    ({"dtype": torch.float16}, False),
    ({"d": 96}, False),
    ({"d": 32}, False),
    ({"hq": 6, "hkv": 4}, False),                 # Hkv does not divide Hq
    ({"s": 2049, "b": 1}, False),
    ({"bias": "per_head"}, False),
    ({"bias": "padding"}, False),
])
def test_dispatch_takes_the_kernels_by_what_it_sees(kw, takes, monkeypatch):
    """ops.attention.takes_kernels by device, dtype, head dim, group, S and
    bias shape, and attend's route: mha_flash where it takes the kernels,
    else mha under "chunked" and "xla" alike; "flash" always mha_flash."""
    q, k, v, bias = _dispatch_inputs(**kw)
    assert tattn.takes_kernels(q, k, v, bias) is takes
    calls = []
    for name in ("mha_flash", "mha"):
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, **k: calls.append(_n))
    for impl, plain in (("chunked", "mha"), ("xla", "mha"), ("flash", "mha_flash")):
        tattn.attend(q, k, v, bias, impl)
        assert calls.pop() == ("mha_flash" if takes else plain)
    with pytest.raises(ValueError, match="attn_impl='pallas' is not supported"):
        tattn.attend(q, k, v, bias, "pallas")


def test_the_recorder_holds_attention_kernel_under_an_open_outer_step(monkeypatch):
    """Each B1 launch adds 1 to `attention.kernel` in the open outer step
    (the launch itself stubbed: the CPU has no card), `attend` registers
    the counter at 0 on the plain path, and nothing is kept outside an outer
    step or without a profiler."""
    launched = []
    monkeypatch.setattr(fa, "_launch", lambda entry, q, *a: launched.append(entry))
    q, k, v, _ = _dispatch_inputs(device="cpu", d=64, hq=4, hkv=2, s=8, bias=None)
    profiling.RECORDER.clear()
    try:
        fa.flash_attention_fwd(q, k, v)  # no profiler: counted as a launch, not recorded
        with profile(activities=[ProfilerActivity.CPU]):
            fa.flash_attention_fwd(q, k, v)  # no open outer step
            with profiling.outer_step("attack.step", "cpu"):
                tattn.attend(q.float(), k.float(), v.float())
                assert profiling.RECORDER.steps[-1].counters == {"attention.kernel": 0, "attention.calls": 1}
                for _ in range(3):
                    fa.flash_attention_fwd(q, k, v)
        (step,) = profiling.recorded_steps()
        assert step.counters["attention.kernel"] == 3
        assert launched == ["flash_attention_fwd_bf16"] * 5
    finally:
        profiling.RECORDER.clear()
