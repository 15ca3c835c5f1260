"""The grouped expert product of the sparse-expert layers: rows sorted by
expert, each group of rows times its own expert's matrix, in one call.

    out[offs[g-1]:offs[g]] = x[offs[g-1]:offs[g]] @ w[g]      (offs[-1] = 0)

`offs` holds the groups' cumulative end rows on the device, so neither the
call nor its backward reads the group sizes on the host: nothing in it
synchronizes, and a group may be empty. On bf16 CUDA input it is one launch
of PyTorch's grouped GEMM (`torch._grouped_mm`: CUTLASS's sm90 grouped
kernel, `GemmUniversal<GroupProblemShape ...>` in a trace, after a
`prepare_grouped_gemm_data` launch that lays out the groups), forward and
input gradient alike; elsewhere the plain version, one product per group
(which reads `offs` on the host).
"""

from __future__ import annotations

import torch


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x [M, K] with its rows sorted by group, w [G, K, N], offs [G] int32
    cumulative end rows (offs[-1] == M) -> [M, N] in x's dtype.
    Differentiable in x and w."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=offs)
    return grouped_matmul_plain(x, w, offs)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The same product as one matmul per group (the ends read on the
    host)."""
    ends = offs.tolist()
    starts = [0] + ends[:-1]
    return torch.cat([x[a:b] @ w[g] for g, (a, b) in enumerate(zip(starts, ends))], dim=0)
