"""Attention with a hand-written forward (B1) and backward (B2): wrappers,
launch counter, plain PyTorch versions and the autograd Function.

Replaces the Pallas TPU kernels of `roboticattack_tpu/ops/flash_attention.py`:
`_fwd_kernel` (B1, launched by `_fwd_pallas`) and `_bwd_kernel` (B2, by
`_bwd_pallas`), joined there by a custom VJP. The CUDA source is
`roboticattack_torch/csrc/flash_attention.cu`; its header says how the work
is laid out and what bounds it.

Per (batch, query head h, key/value head h // group), in f32: S = Q K^T *
d^-1/2 (+ bias); P = softmax(S) with the row max subtracted; O = P V with P
rounded to q's dtype first. The backward recomputes P (f32, unrounded): dP =
dO V^T, dS = P * (dP - rowsum(dP * P)), dQ = dS K * scale, dK = dS^T Q *
scale, dV = P^T dO, all with f32 operands, dK and dV summed over the group.

On a CPU tensor, and only there, the Function runs the plain versions
(`flash_attention_fwd_plain` / `flash_attention_bwd_plain`, the Pallas
kernels' arithmetic operation by operation). On a CUDA tensor it launches the
kernels or raises: they take bf16 q [B, H, S, d] and k/v [B, H / group, S, d]
with d in KERNEL_HEAD_DIMS and 1 <= S <= 2048, as strided views with unit
stride along d, and no bias or an f32 [B, S, S] one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.profiling import count

KERNEL_HEAD_DIMS = (64, 72, 80, 128)  # 72 runs the 80-column instance, zero-filled
MAX_SEQ = 2048
MAX_ROWS = 65535  # batch x heads of one launch: the grid's y extent


def _scale(q: torch.Tensor) -> float:
    return q.shape[-1] ** -0.5


def _grouped(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """k or v with each key/value head repeated over its group of q heads."""
    group = q.shape[1] // kv.shape[1]
    return kv if group == 1 else kv.repeat_interleave(group, dim=1)


def _ungrouped(g: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """A [B, H, S, d] gradient summed over each key/value head's group."""
    b, h, s, d = g.shape
    return g if h == kv_heads else g.reshape(b, kv_heads, h // kv_heads, s, d).sum(dim=2)


def _probs(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 softmax of both Pallas kernels: [B, H, S, S]."""
    s = torch.matmul(q.float(), _grouped(q, k).float().transpose(-1, -2)) * _scale(q)
    if bias is not None:
        s = s + bias[:, None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def flash_attention_fwd_plain(q, k, v, bias) -> torch.Tensor:
    """B1's arithmetic in plain PyTorch: q [B, H, S, d], k/v [B, H / group,
    S, d], bias None or [B, S, S] f32 -> [B, H, S, d] in q.dtype."""
    p = _probs(q, k, bias)
    return torch.matmul(p.to(q.dtype).float(), _grouped(q, v).float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, bias, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2's arithmetic in plain PyTorch, written out (not autograd through
    the forward): -> (dq, dk, dv) in q.dtype, dk and dv summed over each
    key/value head's group in f32."""
    scale = _scale(q)
    p = _probs(q, k, bias)
    do_f, v_f = do.float(), _grouped(q, v).float()
    dp = torch.matmul(do_f, v_f.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    q_f, k_f = q.float(), _grouped(q, k).float()
    hkv = k.shape[1]
    dq = (torch.matmul(ds, k_f) * scale).to(q.dtype)
    dk = _ungrouped(torch.matmul(ds.transpose(-1, -2), q_f) * scale, hkv).to(q.dtype)
    dv = _ungrouped(torch.matmul(p.transpose(-1, -2), do_f), hkv).to(q.dtype)
    return dq, dk, dv


def _kernel_layout(t: torch.Tensor) -> bool:
    """A strided [B, H, S, d] view the kernels read as it is: unit stride
    along d, 16-byte aligned rows, heads and batch rows, S rows within 2^31
    elements (the kernels' 32-bit row offsets)."""
    st, n = t.stride(), t.shape
    return (st[3] == 1 and t.data_ptr() % 16 == 0 and st[2] * n[2] < 2**31
            and all(x % 8 == 0 for x, m in zip(st[:3], n[:3]) if m > 1))


def _bias_layout(bias: torch.Tensor) -> bool:
    """A [B, S, S] bias the kernels read as it is: contiguous [S, S] rows,
    16-byte aligned, and each batch row 16-byte aligned where S % 4 == 0
    (the kernels' 16-byte copies)."""
    sb, row, one = bias.stride()
    s = bias.shape[-1]
    return ((s == 1 or (one == 1 and row == s)) and bias.data_ptr() % 16 == 0
            and (s % 4 != 0 or bias.shape[0] == 1 or sb % 4 == 0))


def kernel_shape_problem(q, k, v) -> Optional[str]:
    """What the CUDA kernels do not take in q/k/v's shapes and dtypes, or
    None."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return "the CUDA attention kernels take q [B, H, S, D] and k/v [B, Hkv, S, D]"
    b, h, s, d = q.shape
    kb, hkv, ks, kd = k.shape
    if (kb, ks, kd) != (b, s, d) or hkv == 0 or h % hkv:
        return "the CUDA attention kernels take k/v [B, Hkv, S, D] with Hkv dividing H"
    if not (q.dtype is torch.bfloat16 and k.dtype is torch.bfloat16 and v.dtype is torch.bfloat16):
        return "the CUDA attention kernels take bf16 q/k/v"
    if d not in KERNEL_HEAD_DIMS:
        return "the CUDA attention kernels take head dim 64, 72, 80 or 128"
    if not 1 <= s <= MAX_SEQ:
        return f"the CUDA attention kernels take 1 <= S <= {MAX_SEQ}"
    if b * h > MAX_ROWS:
        return f"the CUDA attention kernels take B x H <= {MAX_ROWS}"
    return None


def _kernel_input_problem(q, k, v, bias) -> Optional[str]:
    """What the CUDA kernels do not take in these inputs, or None."""
    problem = kernel_shape_problem(q, k, v)
    if problem is not None:
        return problem
    b, _, s, _ = q.shape
    if bias is not None:
        if bias.dtype != torch.float32 or bias.dim() != 3 or bias.shape[0] not in (1, b) or bias.shape[1:] != (s, s):
            return "the CUDA attention kernels take no bias or an f32 bias [B, S, S]"
        if not _bias_layout(bias):
            return ("the CUDA attention kernels take a bias of contiguous [S, S] rows, each batch row's 16-byte "
                    "aligned where S % 4 == 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            return (f"the CUDA attention kernels take unit stride along D and 16-byte aligned rows, heads and "
                    f"batch rows; {name} has strides {t.stride()}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t is not None and t.device != q.device:
            return f"attention operands on different devices: {name} on {t.device}, q on {q.device}"
    return None


def check_kernel_inputs(q, k, v, bias) -> None:
    """Raise ValueError, naming the shapes, on anything the CUDA kernels do
    not take."""
    problem = _kernel_input_problem(q, k, v, bias)
    if problem is not None:
        bias_desc = "None" if bias is None else f"{tuple(bias.shape)} {bias.dtype}"
        raise ValueError(f"{problem}; got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
                         f"v {tuple(v.shape)} {v.dtype}, bias {bias_desc}")


def _bshd(b: int, h: int, s: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, S, d] view of [B, S, H, d] memory: its transpose(1, 2)
    is contiguous, so the model's reshape back to [B, S, H * d] copies
    nothing."""
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _strides(*ts: torch.Tensor):
    """The (batch, head, row) element strides of each tensor, as a C array."""
    flat = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _bias_args(bias: Optional[torch.Tensor]):
    if bias is None:
        return None, 0
    return bias.data_ptr(), bias.stride(0) if bias.shape[0] > 1 else 0


def _launch(entry: str, q: torch.Tensor, *args) -> None:
    """Call `entry` of the kernel library on q's device and current stream,
    raising on a CUDA error of the set-up or the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry} launches a CUDA kernel; got a tensor on {q.device}")
    lib = _bind(_load())
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {msg} (cudaError {rc})")


def flash_attention_fwd(q, k, v, bias=None):
    """Launch B1 on the current stream: -> (o [B, H, S, d] bf16, row max
    [B*H, S] f32, row sum of exp [B*H, S] f32). Counts the launch, and in
    the profiler's recorder `attention.kernel`."""
    check_kernel_inputs(q, k, v, bias)
    b, h, s, d = q.shape
    o = _bshd(b, h, s, d, q)
    stat_m = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    stat_l = torch.empty_like(stat_m)
    _launch("flash_attention_fwd_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _strides(q, k, v, o), *_bias_args(bias), stat_m.data_ptr(), stat_l.data_ptr(),
            b, h, k.shape[1], s, d, _scale(q))
    flash_attention.launches["fwd"] += 1
    count("attention.kernel")
    return o, stat_m, stat_l


def flash_attention_bwd(q, k, v, bias, do, stat_m, stat_l):
    """Launch B2 on the current stream with B1's row statistics: -> (dq,
    dk, dv) bf16, dk/dv summed over each key/value head's group. Counts the
    launch."""
    check_kernel_inputs(q, k, v, bias)
    if do.shape != q.shape or do.dtype != q.dtype or not _kernel_layout(do):
        raise ValueError(f"dO must be a {tuple(q.shape)} {q.dtype} view with unit stride along D and 16-byte "
                         f"aligned rows; got {tuple(do.shape)} {do.dtype}, strides {do.stride()}")
    b, h, s, d = q.shape
    for name, t in (("stat_m", stat_m), ("stat_l", stat_l)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, s) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [{b * h}, {s}]; got {tuple(t.shape)} {t.dtype}")
    hkv = k.shape[1]
    dq, dk, dv = _bshd(b, h, s, d, q), _bshd(b, hkv, s, d, q), _bshd(b, hkv, s, d, q)
    dvec = torch.empty_like(stat_m)
    _launch("flash_attention_bwd_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dq, dk, dv), *_bias_args(bias),
            stat_m.data_ptr(), stat_l.data_ptr(), dvec.data_ptr(), b, h, hkv, s, d, _scale(q))
    flash_attention.launches["bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            o, stats = flash_attention_fwd_plain(q, k, v, bias), ()
        else:
            o, *stats = flash_attention_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, *stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, *stats = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, bias, do)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, bias, do if _kernel_layout(do) else do.contiguous(),
                                             *stats)
        return dq, dk, dv, None


def flash_attention(q, k, v, bias=None):
    """q [B, H, S, d], k/v [B, H / group, S, d] (one dtype), bias None or
    [B, S, S] f32 additive -> [B, H, S, d]. Differentiable in q, k, v (B2),
    not in the bias."""
    return _FlashAttention.apply(q, k, v, bias)


flash_attention.launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for key in flash_attention.launches:
        flash_attention.launches[key] = 0


def mha_flash(q, k, v, bias: Optional[torch.Tensor] = None):
    """Drop-in for ops.attention.mha (grouped key/value heads included) with
    a bias that is None or [B, 1, S, S] ([1, 1, S, S] for every row), which
    goes in as the [B, S, S] view of its one head. Views the kernels cannot
    read as they are are copied first."""
    if bias is not None:
        if bias.dim() != 4 or bias.shape[1] != 1:
            raise ValueError(f"per-head bias not supported; squeeze to [B, 1, S, S] (got {tuple(bias.shape)})")
        bias = bias[:, 0].float()
        if not _bias_layout(bias):
            bias = bias.contiguous()
    if q.device.type == "cuda":
        q, k, v = (t if _kernel_layout(t) else t.contiguous() for t in (q, k, v))
    return flash_attention(q, k, v, bias)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.flash_attention_fwd_bf16.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_attention_fwd_bf16.argtypes = [ptr] * 6 + [i64] + [ptr] * 2 + [i32] * 5 + [f32, ptr]
        lib.flash_attention_fwd_bf16.restype = i32
        lib.flash_attention_bwd_bf16.argtypes = [ptr] * 9 + [i64] + [ptr] * 3 + [i32] * 5 + [f32, ptr]
        lib.flash_attention_bwd_bf16.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _load() -> ctypes.CDLL:
    from .kernel_build import load

    return load("flash_attention")
