"""The CUDA int4 dequant-matmul kernel (roboticattack_torch/csrc/q4_matmul.cu)
against its plain PyTorch version, on the card.

Every test here carries the `cuda` marker and skips where no card is
present. The file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch (the repository's conftest imports jax, hence
`--noconftest`):

    python -m pytest tests/test_torch_q4_matmul_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from roboticattack_torch.ops.q4_matmul import entry_for, q4_matmul, q4_matmul_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mk(out_dim, in_dim, gs, m, device, seed=5):
    """Random packed s4 bytes, positive group scales, bf16 activations [m, 1, in]."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(out_dim, in_dim // 2), dtype=np.int64).astype(np.int8)
    scale = (rng.standard_normal((out_dim, in_dim // gs)).astype(np.float32) * 0.02) ** 2 + 1e-4
    y = rng.standard_normal((m, 1, in_dim)).astype(np.float32)
    return (torch.from_numpy(y).to(device, torch.bfloat16), torch.from_numpy(w).to(device),
            torch.from_numpy(scale).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["grouped", "dense"])
@pytest.mark.parametrize("out_dim,in_dim,gs,m", [
    (4096, 4096, 128, 1), (4096, 4096, 128, 8), (11008, 4096, 128, 8),
    (4096, 11008, 128, 1), (4096, 11008, 128, 8),
    (384, 768, 128, 13),   # ragged output edge, m > 8 (2 n-tiles)
    (200, 512, 64, 3),     # groups of 64, out not a multiple of 16
    (64, 2048, 1024, 2),   # one group spans 8 k-blocks
    (200, 512, 128, 3),    # ragged output edge, m < 8
    (384, 1024, 256, 5),   # groups of 256 (2 k-blocks)
    (96, 384, 128, 4),     # an odd count of 128-channel k-blocks
    (4096, 4096, 128, 2),
    (4096, 4096, 32, 8),   # groups of 32 (4 scales a row a k-block)
    (4096, 4096, 64, 1),   # groups of 64 (2)
    (200, 352, 32, 5),     # a partial last k-block (in % 128 == 96)
    (96, 320, 64, 9),      # a partial last k-block (in % 128 == 64), m > 8
    (4096, 4096, 128, 56),   # the Jacobi pass at bs 8: 7 n-tiles
    (4096, 4096, 64, 57),    # m not a multiple of 8: 8 n-tiles, the last ragged
    (4096, 4096, 32, 64),    # 8 full n-tiles
    (1024, 4096, 64, 65),    # two row chunks of 64 (a tp=4 rank's q/k/v)
    (4096, 2752, 64, 3),     # a tp=4 rank's down_w: 21.5 k-blocks
    (2752, 4096, 32, 8),
    (4096, 2752, 32, 57),
    (11008, 4096, 64, 24),   # 4 n-tiles, the last empty
])
def test_cuda_kernel_matches_plain(cuda, mode, out_dim, in_dim, gs, m):
    """Both sides accumulate in f32 in different orders and round the output
    to bf16, so they differ by at most a couple of bf16 ulps (2^-8
    relative) of the largest output."""
    y, w, scale = _mk(out_dim, in_dim, gs, m, cuda)
    before = dict(q4_matmul.launches)
    got = q4_matmul(y, w, scale, mode=mode)
    torch.cuda.synchronize()
    assert q4_matmul.launches[mode] == before[mode] + 1
    assert got.shape == (m, 1, out_dim) and got.dtype == torch.bfloat16
    want = q4_matmul_plain(y, w, scale, mode, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2**-7 * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """Wrong dtype, a strided operand or an unsupported group size raise
    before any launch."""
    y, w, scale = _mk(256, 512, 128, 2, cuda)
    before = dict(q4_matmul.launches)
    with pytest.raises(ValueError, match="bf16 y"):
        q4_matmul(y.float(), w, scale)
    with pytest.raises(ValueError, match="contiguous"):
        q4_matmul(y, w.t().contiguous().t(), scale)
    y96, w96, s96 = _mk(256, 576, 96, 2, cuda)
    with pytest.raises(ValueError, match="group size"):
        q4_matmul(y96, w96, s96)
    with pytest.raises(ValueError, match="different devices"):
        q4_matmul(y, w.cpu(), scale)
    assert q4_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode,gs", [
    ("grouped", 128), ("grouped", 256), ("grouped", 64), ("grouped", 32),
    ("dense", 128), ("dense", 64), ("dense", 32),
])
def test_cuda_dispatch_counts_the_body_that_ran(cuda, mode, gs):
    """Every group size launches the one tensor-core body through its
    mode's entry (groups of 32/64 in grouped mode too), counted once in its
    mode."""
    y, w, scale = _mk(256, 1024, gs, 4, cuda)
    assert entry_for(mode, 1024, 1024 // gs) == f"q4_matmul_{mode}_mma_bf16"
    before = dict(q4_matmul.launches)
    got = q4_matmul(y, w, scale, mode=mode)
    torch.cuda.synchronize()
    assert q4_matmul.launches == dict(before, **{mode: before[mode] + 1})
    want = q4_matmul_plain(y, w, scale, mode, torch.bfloat16)
    assert (got.float() - want.float()).abs().max().item() <= 2**-7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,gs", [("grouped", 128), ("grouped", 64), ("grouped", 32), ("dense", 128),
                                     ("dense", 64), ("dense", 32)])
@pytest.mark.parametrize("out_dim,in_dim,m", [(4096, 11008, 8), (11008, 4096, 1), (4096, 4096, 3), (4096, 4096, 56),
                                              (4096, 11008, 57), (11008, 4096, 64), (4096, 4096, 65)])
def test_cuda_mma_body_is_bit_deterministic(cuda, mode, gs, out_dim, in_dim, m):
    """The warps' partials are summed in a fixed order: two calls give the
    same bits (each scale layout: 1, 2 and 4 scales a row a k-block; 1 to 8
    n-tiles and two row chunks)."""
    y, w, scale = _mk(out_dim, in_dim, gs, m, cuda)
    first = q4_matmul(y, w, scale, mode=mode)
    second = q4_matmul(y, w, scale, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [128, 64])
@pytest.mark.parametrize("out_dim,in_dim", [(4096, 4096), (11008, 4096), (4096, 11008)])
def test_cuda_grouped_kernel_at_the_jacobi_pass_shape(cuda, out_dim, in_dim, gs):
    """The Jacobi pass at bs=8 sends y [8, 7, in] (m = 56 rows, seven
    n-tiles of 8 fed by one read of the weights) through B4, at the 7B's
    groups of 128 and at 64 (explicit int4:64); within a couple of bf16 ulps
    (2^-7 of the largest output) of the plain version."""
    y, w, scale = _mk(out_dim, in_dim, gs, 56, cuda)
    y = y.reshape(8, 7, in_dim)
    before = dict(q4_matmul.launches)
    got = q4_matmul(y, w, scale)
    torch.cuda.synchronize()
    assert q4_matmul.launches == dict(before, grouped=before["grouped"] + 1)
    assert got.shape == (8, 7, out_dim) and got.dtype == torch.bfloat16
    want = q4_matmul_plain(y, w, scale, "grouped", torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2**-7 * want.float().abs().max().item(), err
