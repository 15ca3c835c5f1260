"""The port's int4 dequant-matmul (roboticattack_torch/ops/q4_matmul.py)
against the JAX package's Pallas kernel (run in interpret mode, as its own
tests run it on the CPU) and its f32 reference dequant.

On the CPU the wrapper computes the plain version; the CUDA kernel itself is
held against the plain version on the card by test_torch_q4_matmul_cuda.py
(and by chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.ops.q4_matmul import q4_matmul as jax_q4_matmul
from roboticattack_tpu.ops.q4_matmul import q4_reference
from roboticattack_torch.ops.q4_matmul import (
    q4_matmul,
    q4_matmul_plain,
    reset_launches,
)

SHAPES = [
    (256, 512, 1, 1),     # matvec
    (256, 512, 3, 7),     # Jacobi-pass shape, m=21
    (384, 768, 2, 1),     # out not a multiple of the JAX tile (256)
]


def _mk(out_dim, in_dim, gs, b, s, seed=0):
    """Random packed s4 bytes, positive group scales, activations (numpy)."""
    rng = np.random.default_rng(seed)
    g = in_dim // gs
    w = rng.integers(-128, 128, size=(out_dim, in_dim // 2), dtype=np.int64).astype(np.int8)
    scale = (rng.standard_normal((out_dim, g)).astype(np.float32) * 0.02) ** 2 + 1e-4
    y = rng.standard_normal((b, s, in_dim)).astype(np.float32)
    return y, w, scale


@pytest.mark.parametrize("mode", ["grouped", "dense"])
@pytest.mark.parametrize("out_dim,in_dim,b,s", SHAPES)
def test_plain_f32_matches_jax_interpret(mode, out_dim, in_dim, b, s):
    """op_dtype=float32 is the JAX kernel's interpret-mode arithmetic: f32
    activations, f32 contraction. Tolerance: both sum in f32, in different
    orders (per-group partials vs the interpreter's sequential group loop),
    so they agree to a few f32 ulps of the output's magnitude."""
    y, w, scale = _mk(out_dim, in_dim, gs=128, b=b, s=s)
    want = np.asarray(jax_q4_matmul(
        jnp.asarray(y), jnp.asarray(w), jnp.asarray(scale), tile_o=256,
        mode=mode, interpret=True,
    ))
    got = q4_matmul_plain(
        torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(scale),
        mode, torch.float32,
    ).numpy()
    assert got.shape == (b, s, out_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["grouped", "dense"])
@pytest.mark.parametrize("out_dim,in_dim,b,s", SHAPES)
def test_plain_bf16_matches_reference(mode, out_dim, in_dim, b, s):
    """op_dtype=bfloat16 is the kernel's compiled semantics (bf16
    activations; dense rounds the dequantized weights to bf16) and returns
    bf16. Against the f32 reference dequant the error is bf16 rounding:
    the JAX package's own kernel test bound (rtol 2e-2, atol 2e-2 * max)."""
    y, w, scale = _mk(out_dim, in_dim, gs=128, b=b, s=s)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    want = np.asarray(q4_reference(
        jnp.asarray(yb.float().numpy()), jnp.asarray(w), jnp.asarray(scale)
    ))
    got = q4_matmul_plain(
        yb, torch.from_numpy(w), torch.from_numpy(scale), mode, torch.bfloat16
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max()
    )


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    """A CPU tensor takes the plain f32 version and launches nothing."""
    reset_launches()
    y, w, scale = (torch.from_numpy(a) for a in _mk(256, 512, 128, 2, 1, seed=3))
    for mode in ("grouped", "dense"):
        got = q4_matmul(y, w, scale, mode=mode)
        torch.testing.assert_close(got, q4_matmul_plain(y, w, scale, mode, torch.float32),
                                   rtol=0, atol=0)
    assert q4_matmul.launches == {"grouped": 0, "dense": 0}


def test_wrapper_rejects_bad_shapes_and_modes():
    y, w, scale = (torch.from_numpy(a) for a in _mk(256, 512, 128, 1, 1))
    with pytest.raises(ValueError, match="packed width"):
        q4_matmul(y[..., :-2], w, scale)
    with pytest.raises(ValueError, match="groups"):
        q4_matmul(y, w, scale[:, :3])
    with pytest.raises(ValueError, match="mode"):
        q4_matmul(y, w, scale, mode="fused")
