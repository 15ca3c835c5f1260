"""Row normalisation of every transformer block: the one entry the models
call (`layer_norm`, `rms_norm`: the hand-written CUDA kernels wherever they
take the input, else the plain versions), the plain PyTorch versions, and
the kernels' wrappers, launch counter and autograd Function.

The kernels (`roboticattack_torch/csrc/norm.cu`, whose header gives their
arithmetic and what bounds them) replace no TPU kernel: the JAX package
leaves its norms to XLA, which fuses each into one pass. They take bf16 rows
on CUDA of a width that is a multiple of 8, at most MAX_WIDTH, with bf16
weights, and keep the plain versions' rounding points: LayerNorm in f32 with
one rounding to bf16; RMSNorm's normalised row rounded to bf16 before the
weight (HF's LlamaRMSNorm); the backward in f32 from the bf16 gradient.
The CPU, and f32 and f64 input anywhere, run the plain versions, the eager
chains the models ran before. Any other input on CUDA that the kernels do not
take (a width they refuse, weights in another dtype) raises: the card never
falls back to the plain chain.

Each entry call counts `norm.calls` once and `norm.kernel` 0, and each
forward kernel launch adds 1 to `norm.kernel`, in the profiler's recorder
(`utils/profiling.count`): a program that launches nothing reads 0. The
wrappers also count their host launches in `launches` (fwd, bwd, wgrad),
which a run on the card reads around a step to see that every norm of it
took the kernels; a CUDA graph's replay launches nothing from the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.profiling import count

MAX_WIDTH = 5120  # the kernels' widest row (Llama-2-13B's hidden size)

launches = {"fwd": 0, "bwd": 0, "wgrad": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics and affine, one rounding to x.dtype at the end."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics; the normalised value is cast to x.dtype BEFORE the
    weight multiply (HF LlamaRMSNorm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return weight * normed


def kernel_problem(x: torch.Tensor, *params: torch.Tensor) -> Optional[str]:
    """What the kernels do not take in x [..., n] and its [n] weights
    (dtypes, widths, devices), or None. The device type is not checked."""
    n = x.shape[-1] if x.dim() else 0
    if x.dtype is not torch.bfloat16 or any(p.dtype is not torch.bfloat16 for p in params):
        return "the CUDA norm kernels take a bf16 input and bf16 weights"
    if x.numel() == 0 or n % 8 or n > MAX_WIDTH:
        return f"the CUDA norm kernels take non-empty rows of a width that is a multiple of 8, at most {MAX_WIDTH}"
    if any(tuple(p.shape) != (n,) or p.device != x.device for p in params):
        return "the CUDA norm kernels take weights of shape [n] on the input's device"
    return None


def takes_kernel(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether the kernels run this normalisation: every input on CUDA but
    an f32 or f64 one. Raises ValueError (kernel_problem's reason) for such
    an input that the kernels do not take."""
    if not x.is_cuda or x.dtype in (torch.float32, torch.float64):
        return False
    _check(x, *params)
    return True


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with scale and bias: the kernels where
    `takes_kernel` (which raises for a CUDA input they do not take), else
    `layer_norm_plain`. Counted in `norm.calls`."""
    count("norm.calls")
    count("norm.kernel", 0)
    if takes_kernel(x, scale, bias):
        return _Norm.apply(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim (HF LlamaRMSNorm's roundings): the kernels
    where `takes_kernel` (which raises for a CUDA input they do not take),
    else `rms_norm_plain`. Counted in `norm.calls`."""
    count("norm.calls")
    count("norm.kernel", 0)
    if takes_kernel(x, weight):
        return _Norm.apply(x, weight, None, eps)
    return rms_norm_plain(x, weight, eps)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy where it is not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as [rows, n] the kernels read as it is: unit stride along n, a row
    stride that is a multiple of 8 elements, 16-byte aligned (a contiguous
    copy where it is not; a slice of a wider row, as MLA's kv latent, goes
    in without one)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.stride(0) < x2.shape[1] or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return x2


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(entry: str, x: torch.Tensor, *args) -> None:
    """Call `entry` of the kernel library on x's device and current stream,
    raising on a CUDA error of the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{entry} launches a CUDA kernel; got a tensor on {x.device}")
    lib = _bind(_load())
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: {lib.norm_error_string(rc).decode()} (cudaError {rc})")


def _check(x, *params) -> None:
    problem = kernel_problem(x, *params)
    if problem is not None:
        raise ValueError(f"{problem}; got x {tuple(x.shape)} {x.dtype}, weights "
                         f"{[(tuple(p.shape), p.dtype) for p in params]}")


def norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Launch the forward on the current stream: LayerNorm with `bias`,
    RMSNorm without. -> (y shaped as x, bf16; each row's mean [rows] f32,
    None for RMSNorm; each row's rstd [rows] f32). Counts the launch, and
    in the profiler's recorder `norm.kernel`."""
    params = (weight,) if bias is None else (weight, bias)
    _check(x, *params)
    x2 = _rows(x)
    rows, n = x2.shape
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    mean = None if bias is None else torch.empty_like(rstd)
    w, b = _aligned(weight), None if bias is None else _aligned(bias)
    _launch("norm_fwd_bf16", x, x2.data_ptr(), x2.stride(0), w.data_ptr(), _ptr(b), y.data_ptr(), _ptr(mean),
            rstd.data_ptr(), rows, n, eps)
    launches["fwd"] += 1
    count("norm.kernel")
    return y.view(x.shape), mean, rstd


def norm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, mean: Optional[torch.Tensor],
             rstd: torch.Tensor) -> torch.Tensor:
    """Launch the backward's dx on the current stream from the forward's
    statistics (LayerNorm where `mean` is given) -> dx shaped as x, bf16.
    Counts the launch."""
    _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}; got {tuple(dy.shape)} {dy.dtype}")
    x2 = _rows(x)
    rows, n = x2.shape
    dy2 = _aligned(dy.reshape(rows, n))
    dx = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    _launch("norm_bwd_bf16", x, x2.data_ptr(), x2.stride(0), dy2.data_ptr(), _aligned(weight).data_ptr(),
            _ptr(mean), rstd.data_ptr(), dx.data_ptr(), rows, n, int(mean is not None))
    launches["bwd"] += 1
    return dx.view(x.shape)


def norm_wgrad(x: torch.Tensor, dy: torch.Tensor, mean: Optional[torch.Tensor], rstd: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the weight gradients' two passes on the current stream ->
    (dweight [n] bf16, dbias [n] bf16 for LayerNorm (`mean` given), else
    None), summed over the rows in a fixed order. Counts the launch."""
    _check(x)
    x2 = _rows(x)
    rows, n = x2.shape
    dy2 = _aligned(dy.reshape(rows, n))
    layer = mean is not None
    lib = _bind(_load())
    part = torch.empty((2 if layer else 1, lib.norm_wgrad_parts(rows), n), dtype=torch.float32, device=x.device)
    dw = torch.empty(n, dtype=x.dtype, device=x.device)
    db = torch.empty_like(dw) if layer else None
    _launch("norm_wgrad_bf16", x, x2.data_ptr(), x2.stride(0), dy2.data_ptr(), _ptr(mean), rstd.data_ptr(),
            part.data_ptr(), dw.data_ptr(), _ptr(db), rows, n, int(layer))
    launches["wgrad"] += 1
    return dw, db


class _Norm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = norm_bwd(x, dy, weight, mean, rstd)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = norm_wgrad(x, dy, mean, rstd)
        return dx, dw, db, None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.norm_fwd_bf16.argtypes is None:
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.norm_fwd_bf16.argtypes = [ptr, i64] + [ptr] * 5 + [i32, i32, f32, ptr]
        lib.norm_fwd_bf16.restype = i32
        lib.norm_bwd_bf16.argtypes = [ptr, i64] + [ptr] * 5 + [i32] * 3 + [ptr]
        lib.norm_bwd_bf16.restype = i32
        lib.norm_wgrad_parts.argtypes = [i32]
        lib.norm_wgrad_parts.restype = i32
        lib.norm_wgrad_bf16.argtypes = [ptr, i64] + [ptr] * 6 + [i32] * 3 + [ptr]
        lib.norm_wgrad_bf16.restype = i32
        lib.norm_error_string.argtypes = [i32]
        lib.norm_error_string.restype = ctypes.c_char_p
    return lib


def _load() -> ctypes.CDLL:
    from .kernel_build import load

    return load("norm")
