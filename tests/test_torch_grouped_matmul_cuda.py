"""The grouped expert product (roboticattack_torch/ops/grouped_matmul.py:
PyTorch's sm90 grouped GEMM on bf16 CUDA input) against its plain version,
and the sparse-expert layer's routing without a host synchronize, on the
card.

Every test here carries the `cuda` marker and skips where no card is
present. The file imports neither jax nor the JAX package (the
repository's conftest does, hence `--noconftest`):

    python -m pytest tests/test_torch_grouped_matmul_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from roboticattack_torch.models import deepseek
from roboticattack_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _routing(device, tokens=2304, experts=64, k=6, seed=0):
    """Expert choices of `tokens` tokens; the last expert gets none."""
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.rand(tokens, experts, generator=g, device=device)
    scores[:, -1] = -1.0
    return torch.topk(scores, k, dim=-1).indices


@pytest.mark.cuda
@pytest.mark.parametrize("k_in,n_out", [(2048, 1408), (1408, 2048)], ids=["gate_up", "down"])
def test_the_grouped_product_equals_its_plain_version(cuda, k_in, n_out):
    """Moonlight's expert shapes, 13824 routed rows over 64 experts (one
    empty): forward and input gradient within bf16 rounding of the plain
    version's float32 products of the same bf16 operands."""
    idx = _routing(cuda).reshape(-1)
    rows = torch.zeros(64, dtype=torch.int32, device=cuda).scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    offs = rows.cumsum(0, dtype=torch.int32)
    assert int(rows[-1]) == 0
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(idx.numel(), k_in, generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    w = (0.02 * torch.randn(64, k_in, n_out, generator=g, device=cuda)).to(torch.bfloat16)
    up = torch.randn(idx.numel(), n_out, generator=g, device=cuda).to(torch.bfloat16)
    got = grouped_matmul(x, w, offs)
    (gx,) = torch.autograd.grad(got, x, up)
    xf = x.detach().float().requires_grad_(True)
    want = grouped_matmul_plain(xf, w.float(), offs)
    (wx,) = torch.autograd.grad(want, xf, up.float())
    for a, b in ((got, want), (gx, wx)):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b).abs().max())
        assert err <= 2.0 ** -7 * float(b.abs().max()), err


@pytest.mark.cuda
def test_the_sparse_layer_runs_without_a_host_synchronize(cuda):
    """Routing, the sorted rows, the grouped products and the combine,
    forward and backward, with synchronizing calls raising."""
    g = torch.Generator(device=cuda).manual_seed(2)
    e, d, f, t, k = 64, 256, 128, 512, 6
    p = {n: (0.05 * torch.randn(shape, generator=g, device=cuda)).to(torch.bfloat16) for n, shape in
         (("gate_w", (e, d, f)), ("up_w", (e, d, f)), ("down_w", (e, f, d)))}
    y = torch.randn(t, d, generator=g, device=cuda).to(torch.bfloat16).requires_grad_(True)
    w = torch.rand(t, k, generator=g, device=cuda, requires_grad=True)
    idx = _routing(cuda, t, e, k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = deepseek.routed_experts(y, idx, w, p)
        gy, gw = torch.autograd.grad(out.float().square().sum(), (y, w))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = torch.zeros(t, d, device=cuda)
    yf = y.detach().float()
    for j in range(k):
        for ex in range(e):
            sel = idx[:, j] == ex
            h = torch.nn.functional.silu(yf[sel] @ p["gate_w"][ex].float()) * (yf[sel] @ p["up_w"][ex].float())
            want[sel] += w.detach()[sel, j, None] * (h @ p["down_w"][ex].float())
    err = float((out.float() - want).abs().max())
    assert err <= 2.0 ** -6 * float(want.abs().max()), err
    assert torch.isfinite(gy).all() and torch.isfinite(gw).all()
