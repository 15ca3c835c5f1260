"""Attention of the Llama decoder with a hand-written forward (B1) and
backward (B2): wrappers, launch counter, plain PyTorch versions and the
autograd Function.

Replaces the Pallas TPU kernels of `roboticattack_tpu/ops/flash_attention.py`:
`_fwd_kernel` (B1, launched by `_fwd_pallas`) and `_bwd_kernel` (B2, by
`_bwd_pallas`), joined there by a custom VJP. The CUDA source is
`roboticattack_torch/csrc/flash_attention.cu`; its header says how the work
is laid out and what bounds it.

Per (batch, head), in f32: S = Q K^T * D^-1/2 + bias; P = softmax(S) with the
row max subtracted; O = P V with P rounded to q's dtype first. The backward
recomputes P (f32, unrounded): dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO, all with f32 operands.

On a CPU tensor, and only there, the Function runs the plain versions
(`flash_attention_fwd_plain` / `flash_attention_bwd_plain`, the Pallas
kernels' arithmetic operation by operation). On a CUDA tensor it launches the
kernels or raises: they take bf16 q/k/v [B, H, S, 128] with 1 <= S <= 2048
and an f32 [B, S, S] bias.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

HEAD_DIM = 128
MAX_SEQ = 2048


def _scale(q: torch.Tensor) -> float:
    return q.shape[-1] ** -0.5


def _probs(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The f32 softmax of both Pallas kernels: [B, H, S, S]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * _scale(q) + bias[:, None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def flash_attention_fwd_plain(q, k, v, bias) -> torch.Tensor:
    """B1's arithmetic in plain PyTorch: q/k/v [B, H, S, D], bias [B, S, S]
    f32 -> [B, H, S, D] in q.dtype."""
    p = _probs(q, k, bias)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, bias, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2's arithmetic in plain PyTorch, written out (not autograd through
    the forward): -> (dq, dk, dv) in q.dtype."""
    scale = _scale(q)
    p = _probs(q, k, bias)
    do_f, v_f = do.float(), v.float()
    dp = torch.matmul(do_f, v_f.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    q_f, k_f = q.float(), k.float()
    dq = (torch.matmul(ds, k_f) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q_f) * scale).to(q.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do_f).to(q.dtype)
    return dq, dk, dv


def check_kernel_inputs(q, k, v, bias) -> None:
    """Raise ValueError, naming the shapes, on anything the CUDA kernels do
    not take."""
    shapes = (f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
              f"v {tuple(v.shape)} {v.dtype}, bias {tuple(bias.shape)} {bias.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"the CUDA attention kernels take q/k/v [B, H, S, D] of one shape; got {shapes}")
    b, _, s, d = q.shape
    if (q.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3:
        raise ValueError(f"the CUDA attention kernels take bf16 q/k/v; got {shapes}")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA attention kernels take head dim {HEAD_DIM}; got {shapes}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"the CUDA attention kernels take 1 <= S <= {MAX_SEQ}; got {shapes}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, s, s):
        raise ValueError(f"the CUDA attention kernels take an f32 bias [B, S, S]; got {shapes}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"the CUDA attention kernels take contiguous tensors; {name} is not ({shapes})")
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA attention kernels take 16-byte aligned tensors; {name} is not")
        if t.device != q.device:
            raise ValueError(f"attention operands on different devices: {name} on {t.device}, q on {q.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _load().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q, k, v, bias):
    """Launch B1 on the current stream: -> (o [B, H, S, D] bf16, row max
    [B*H, S] f32, row sum of exp [B*H, S] f32). Counts the launch."""
    check_kernel_inputs(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd launches a CUDA kernel; got a tensor on {q.device}")
    b, h, s, _ = q.shape
    o = torch.empty_like(q)
    stat_m = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    stat_l = torch.empty_like(stat_m)
    fn = _bind(_load()).flash_attention_fwd_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), o.data_ptr(),
                stat_m.data_ptr(), stat_l.data_ptr(), b * h, h, s, _scale(q), _stream(q))
    _raise_on(rc, "flash_attention_fwd")
    flash_attention.launches["fwd"] += 1
    return o, stat_m, stat_l


def flash_attention_bwd(q, k, v, bias, do, stat_m, stat_l):
    """Launch B2 on the current stream with B1's row statistics: -> (dq,
    dk, dv) bf16. Counts the launch."""
    check_kernel_inputs(q, k, v, bias)
    check_kernel_inputs(do, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd launches a CUDA kernel; got a tensor on {q.device}")
    b, h, s, _ = q.shape
    for name, t in (("stat_m", stat_m), ("stat_l", stat_l)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b * h, s) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [{b * h}, {s}]; got {tuple(t.shape)} {t.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty_like(stat_m)
    fn = _bind(_load()).flash_attention_bwd_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                stat_m.data_ptr(), stat_l.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b * h, h, s, _scale(q), _stream(q))
    _raise_on(rc, "flash_attention_bwd")
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
            dq, dk, dv = flash_attention_bwd(q, k, v, bias, do.contiguous(), *stats)
        return dq, dk, dv, None


def flash_attention(q, k, v, bias):
    """q/k/v [B, H, S, D] (one dtype), bias [B, S, S] f32 additive ->
    [B, H, S, D]. Differentiable in q, k, v (B2), not in the bias."""
    return _FlashAttention.apply(q, k, v, bias)


flash_attention.launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for key in flash_attention.launches:
        flash_attention.launches[key] = 0


def mha_flash(q, k, v, bias: Optional[torch.Tensor] = None):
    """Drop-in for ops.attention.mha when Hq == Hkv and the [B, 1, S, S]
    bias can be squeezed to [B, S, S]; None becomes zeros."""
    b, hq, s, _ = q.shape
    if k.shape[1] != hq or v.shape[1] != hq:
        raise ValueError(f"mha_flash needs as many k/v heads as q heads (no GQA); got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bias is None:
        bias_b = torch.zeros((b, s, s), dtype=torch.float32, device=q.device)
    else:
        if bias.dim() != 4 or bias.shape[1] != 1:
            raise ValueError(f"per-head bias not supported; squeeze to [B, 1, S, S] (got {tuple(bias.shape)})")
        bias_b = bias.float().expand(b, 1, s, s)[:, 0].contiguous()
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias_b)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.flash_attention_fwd_bf16.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_bf16.argtypes = [ptr] * 7 + [i32, i32, i32, f32, ptr]
        lib.flash_attention_fwd_bf16.restype = i32
        lib.flash_attention_bwd_bf16.argtypes = [ptr] * 11 + [i32, i32, i32, f32, ptr]
        lib.flash_attention_bwd_bf16.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _load() -> ctypes.CDLL:
    from .kernel_build import load

    return load("flash_attention")
