"""The CUDA attention kernels B1/B2 (roboticattack_torch/csrc/flash_attention.cu)
against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips where no card is
present. The file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch (the repository's conftest imports jax, hence
`--noconftest`):

    python -m pytest tests/test_torch_flash_attention_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from roboticattack_torch.ops.attention import NEG_INF
from roboticattack_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_plain,
    mha_flash,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, s, device, pad=0, zero_bias=False, seed=3):
    """bf16 q/k/v/dO [B, H, S, 128] and an f32 [B, S, S] causal bias whose
    last `pad` keys of every row but the first are padding."""
    rng = np.random.default_rng(seed)
    qkvd = [torch.from_numpy(rng.standard_normal((b, h, s, 128)).astype(np.float32))
            .to(device, torch.bfloat16) for _ in range(4)]
    if zero_bias:
        bias = torch.zeros((b, s, s), device=device)
    else:
        i = torch.arange(s, device=device)
        bias = torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).expand(b, s, s).clone()
        if pad:
            bias[1:, :, s - pad:] += NEG_INF
    return (*qkvd, bias)


def _close(got, want):
    """Both sides sum in f32 in different orders and round to bf16: a couple
    of bf16 ulps (2^-8 relative) of the largest value."""
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2**-7 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,pad,zero_bias", [
    (8, 32, 288, 12, False),   # the attack step's shape, padded text keys
    (1, 32, 288, 0, False),
    (2, 4, 100, 5, False),     # ragged S
    (2, 4, 128, 0, True),      # all-zero bias
])
def test_cuda_kernels_match_plain(cuda, b, h, s, pad, zero_bias):
    q, k, v, do, bias = _inputs(b, h, s, cuda, pad, zero_bias)
    before = dict(flash_attention.launches)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg, bias)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    _close(out, flash_attention_fwd_plain(q, k, v, bias))
    for got, want in zip((qg.grad, kg.grad, vg.grad), flash_attention_bwd_plain(q, k, v, bias, do)):
        _close(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """f32 operands, head dim 64, S past 2048, a per-head bias and GQA
    raise before any launch."""
    q, k, v, _, bias = _inputs(1, 2, 64, cuda)
    before = dict(flash_attention.launches)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.float(), k.float(), v.float(), bias)
    q64 = q[..., :64].contiguous()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q64, q64, q64, bias)
    long = torch.zeros((1, 1, 2049, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 2048"):
        flash_attention(long, long, long, torch.zeros((1, 2049, 2049), device=cuda))
    with pytest.raises(ValueError, match="per-head bias"):
        mha_flash(q, k, v, bias[:, None].expand(1, 2, 64, 64))
    with pytest.raises(ValueError, match="GQA"):
        mha_flash(q, k[:, :1], v[:, :1])
    assert flash_attention.launches == before
