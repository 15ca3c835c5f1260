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


def _check_against_plain(q, k, v, do, bias):
    """One launch each of B1 and B2 (counted) through the autograd Function,
    against the plain versions."""
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
@pytest.mark.parametrize("b,h,s,pad,zero_bias", [
    (8, 32, 288, 12, False),   # the attack step's shape, padded text keys
    (1, 32, 288, 0, False),
    (2, 4, 100, 5, False),     # ragged S
    (2, 4, 128, 0, True),      # all-zero bias
    (2, 2, 1, 0, False),       # one key: all but row 0 of every tile zero-filled
    (2, 3, 17, 3, False),      # past one 16-row mma tile, inside one 32-row step
    (2, 2, 64, 0, False),      # exactly one 64-row tile, two steps
    (2, 2, 65, 2, False),      # one row into a second tile
    (1, 2, 2048, 0, False),    # MAX_SEQ: 32 tiles, 64 steps
])
def test_cuda_kernels_match_plain(cuda, b, h, s, pad, zero_bias):
    _check_against_plain(*_inputs(b, h, s, cuda, pad, zero_bias))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [40, 288])
def test_cuda_kernels_match_plain_with_mostly_masked_rows(cuda, s):
    """Rows whose keys are NEG_INF but for a few (the diagonal and ~5% of the
    rest, drawn from a seed): the max is set by one or two keys per row."""
    q, k, v, do, _ = _inputs(2, 4, s, cuda)
    rng = np.random.default_rng(s)
    keep = torch.from_numpy(rng.random((2, s, s)) < 0.05).to(cuda) | torch.eye(s, dtype=torch.bool, device=cuda)
    bias = torch.where(keep, 0.0, NEG_INF)
    _check_against_plain(q, k, v, do, bias)


@pytest.mark.cuda
def test_cuda_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give the same bits: B1's o, row max
    and sum of exp; B2's dq, dk, dv."""
    from roboticattack_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    q, k, v, do, bias = _inputs(8, 4, 288, cuda, pad=12)
    first = flash_attention_fwd(q, k, v, bias)
    second = flash_attention_fwd(q, k, v, bias)
    grads = [flash_attention_bwd(q, k, v, bias, do, *first[1:]) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_skipped_steps_change_no_bit(cuda):
    """A warp skips the products of a step whose P is all 0 (here: keys
    above the causal diagonal). Unmasking one entry, bias[5, 200], makes the
    warps that hold query 5 and key 200 compute those all-zero steps instead:
    every output the change cannot reach (o, dq of the other queries; dk, dv
    of the keys past 5 but 200; the row statistics) keeps its bits."""
    from roboticattack_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    q, k, v, do, causal = _inputs(1, 2, 288, cuda)
    touched = causal.clone()
    touched[0, 5, 200] = 0.0
    outs = []
    for bias in (causal, touched):
        o, m, l = flash_attention_fwd(q, k, v, bias)
        outs.append((o, m, l, *flash_attention_bwd(q, k, v, bias, do, m, l)))
    torch.cuda.synchronize()
    rows = torch.ones(288, dtype=torch.bool, device=cuda)
    rows[5] = False
    keys = torch.ones(288, dtype=torch.bool, device=cuda)
    keys[:6] = False
    keys[200] = False
    (o_a, m_a, l_a, dq_a, dk_a, dv_a), (o_b, m_b, l_b, dq_b, dk_b, dv_b) = outs
    assert not torch.equal(o_a[:, :, 5], o_b[:, :, 5])  # the change did reach query 5
    for a, b in ((o_a, o_b), (dq_a, dq_b)):
        assert torch.equal(a[:, :, rows], b[:, :, rows])
    for a, b in ((m_a, m_b), (l_a, l_b)):
        assert torch.equal(a[:, rows], b[:, rows])
    for a, b in ((dk_a, dk_b), (dv_a, dv_b)):
        assert torch.equal(a[:, :, keys], b[:, :, keys])


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    """f32 operands, head dim 96, S past 2048, a per-head bias and key/value
    heads that do not divide the query heads raise before any launch."""
    q, k, v, _, bias = _inputs(1, 2, 64, cuda)
    before = dict(flash_attention.launches)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q.float(), k.float(), v.float(), bias)
    q96 = q[..., :96].contiguous()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q96, q96, q96, bias)
    long = torch.zeros((1, 1, 2049, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="S <= 2048"):
        flash_attention(long, long, long, torch.zeros((1, 2049, 2049), device=cuda))
    with pytest.raises(ValueError, match="per-head bias"):
        mha_flash(q, k, v, bias[:, None].expand(1, 2, 64, 64))
    q3 = torch.cat([q, q[:, :1]], dim=1)
    with pytest.raises(ValueError, match="Hkv dividing H"):
        mha_flash(q3, k, v)
    assert flash_attention.launches == before


def _cell_inputs(b, hq, hkv, s, d, device, bias, seed=5):
    """bf16 q/dO [B, Hq, S, d], k/v [B, Hkv, S, d], and None or the
    decoder's f32 causal + padding bias [B, S, S] (row r's last 3 r keys
    padded)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(h):
        return torch.randn((b, h, s, d), generator=gen, device=device).to(torch.bfloat16)

    q, k, v, do = draw(hq), draw(hkv), draw(hkv), draw(hq)
    if not bias:
        return q, k, v, do, None
    i = torch.arange(s, device=device)
    t = torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).expand(b, s, s).clone()
    for r in range(b):
        if 3 * r:
            t[r, :, s - 3 * r:] += NEG_INF
    return q, k, v, do, t


# the benchmark cells' attentions, then the instances' edges
CELL_SHAPES = [  # b, hq, hkv, s, d, bias
    (8, 32, 32, 608, 80, True),    # Phi-2's decoder
    (8, 16, 16, 577, 64, False),   # CLIP ViT-L/14 at 336 px (+ cls)
    (8, 16, 16, 261, 64, False),   # DINOv2 ViT-L/14 with registers at 224 px
    (8, 16, 16, 256, 72, False),   # SigLIP so400m/14 at 224 px
    (8, 32, 8, 288, 128, True),    # Mistral-7B's decoder, 8 key/value heads
    (2, 8, 2, 100, 72, True),      # d 72 with a bias, ragged S, group 4
    (2, 4, 1, 65, 80, False),      # one row into a second tile, group 4
    (1, 2, 2, 1, 64, False),       # one key
    (1, 8, 2, 2048, 64, True),     # MAX_SEQ, group 4
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,bias", CELL_SHAPES)
def test_cuda_kernels_match_plain_at_every_instance(cuda, b, hq, hkv, s, d, bias):
    """B1/B2 at the cells' shapes (every head dim, grouped key/value heads,
    with and without a bias) against the plain versions within 2^-7
    max|plain|, and bit-equal over two launches."""
    q, k, v, do, t = _cell_inputs(b, hq, hkv, s, d, cuda, bias)
    _check_against_plain(q, k, v, do, t)
    from roboticattack_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    first, second = flash_attention_fwd(q, k, v, t), flash_attention_fwd(q, k, v, t)
    grads = [flash_attention_bwd(q, k, v, t, do, *first[1:]) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    for x, y in zip(*grads):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72])
def test_cuda_strided_views_go_in_as_they_are(cuda, d):
    """q/k/v as the models hand them over (the towers' slices of a packed
    [B, S, 3, H, d] projection; the decoders' transposed [B, S, H, d]
    heads) give the bits of contiguous copies, and mha_flash copies nothing:
    its output's transpose(1, 2) is contiguous."""
    b, s, h = 2, 77, 4
    gen = torch.Generator(device=cuda).manual_seed(d)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    do = torch.randn((b, s, h, d), generator=gen, device=cuda).to(torch.bfloat16).transpose(1, 2)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = mha_flash(*leaves)
    out.backward(do)
    copies = [x.contiguous().requires_grad_(True) for x in (q, k, v)]
    want = mha_flash(*copies)
    want.backward(do.contiguous())
    torch.cuda.synchronize()
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, want)
    for x, y in zip(leaves, copies):
        assert torch.equal(x.grad, y.grad)
