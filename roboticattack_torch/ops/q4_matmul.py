"""Fused int4 dequant-matmul of the decode tail: wrapper, launch counter and
plain PyTorch version.

Replaces the Pallas TPU kernel `roboticattack_tpu/ops/q4_matmul.py:q4_matmul`
with its two kernel bodies: `_kernel_grouped` (B4, mode="grouped", the
decode tail's default) and `_kernel_dense` (B5, mode="dense"). The CUDA
source is `roboticattack_torch/csrc/q4_matmul.cu`; its header says how the
work is laid out.

What bounds it on the card: memory bytes. At decode batch sizes (m = B*S <=
16 rows) every call streams the packed weights once, out*in/2 bytes, plus the
f32 scales, out*G*4 bytes, against the card's bandwidth (3.35 TB/s on an
H100 SXM); the operations (2*m*out*in) are far below the tensor-core peak.

Two kernel bodies, chosen from the shape before the launch (`body_for`):
"mma" for dense mode and for grouped mode with a group size that is a
multiple of 128 channels (the 7B's decode tail): bf16 tensor cores on
nibbles unpacked (and, in dense mode, dequantized) in registers, the weights
streamed through a shared-memory ring with cp.async, K split among a block's
warps. "fma" for grouped mode with groups of 32 or 64 channels: CUDA-core
FMAs, activations staged in shared memory per K tile.

Layout contract (the JAX package's models/quant.py): w [out, in/2] int8 with
channel 2j in the low nibble and 2j+1 in the high nibble; scale [out, G] f32
grouped over the contraction.

On a CPU tensor, and only there, `q4_matmul` computes the plain version
(op_dtype=float32, the JAX kernel's interpret-mode arithmetic). On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

MODES = ("grouped", "dense")
BODIES = ("mma", "fma")
# the group sizes (channels) the CUDA kernel takes: 32 * 2^k, k <= 5, i.e.
# 1, 2, 4, ..., 32 lanes of 32 channels a group (`q4_matmul` and `VLAPolicy`
# both check against this)
KERNEL_GROUP_SIZES = tuple(32 << k for k in range(6))


def _unpack_nibbles(w: torch.Tensor):
    """Packed s4 int8 [..., n/2] -> (lo, hi) int32: lo is channel 2j, hi is
    2j+1. Widened to int32 first: no shifts of int8 tensors."""
    p = w.to(torch.int32)
    return ((p & 15) ^ 8) - 8, p >> 4


def _check_shapes(y: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; supported: {MODES}")
    if y.dim() != 3 or w.dim() != 2 or scale.dim() != 2:
        raise ValueError(
            f"q4_matmul takes y [B, S, in], w [out, in/2], scale [out, G]; got "
            f"{tuple(y.shape)}, {tuple(w.shape)}, {tuple(scale.shape)}"
        )
    out_dim, in_half = w.shape
    if in_half * 2 != y.shape[-1]:
        raise ValueError(f"packed width {in_half} vs activation {y.shape[-1]}")
    if scale.shape[0] != out_dim:
        raise ValueError(f"scale rows {scale.shape[0]} vs weight rows {out_dim}")
    if in_half % scale.shape[1]:
        raise ValueError(f"groups {scale.shape[1]} do not divide packed width {in_half}")


def q4_matmul_plain(
    y: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    mode: str = "grouped",
    op_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: [B, S, in] @
    dequant(w, scale)^T -> [B, S, out] in y.dtype.

    op_dtype is the type the operands are rounded to before the f32
    contraction: float32 reproduces the JAX kernel's interpret mode,
    bfloat16 its compiled semantics on the chip (activations and, in dense
    mode, the dequantized weights rounded to bf16). grouped: per-group f32
    partials of the raw s4 integers, each scaled after its group's
    contraction. dense: dequantized weights, one f32 contraction."""
    _check_shapes(y, w, scale, mode)
    b, s, in_dim = y.shape
    out_dim, in_half = w.shape
    g = scale.shape[1]
    gsz2 = in_half // g
    m = b * s
    y2 = y.reshape(m, in_dim).to(op_dtype).float()
    ye, yo = y2[:, 0::2], y2[:, 1::2]  # channels 2j / 2j+1  [m, in/2]
    lo, hi = _unpack_nibbles(w)
    sc = scale.float()
    if mode == "grouped":
        lo = lo.to(op_dtype).float().reshape(out_dim, g, gsz2)
        hi = hi.to(op_dtype).float().reshape(out_dim, g, gsz2)
        pe = torch.einsum("mgi,ogi->mog", ye.reshape(m, g, gsz2), lo)
        po = torch.einsum("mgi,ogi->mog", yo.reshape(m, g, gsz2), hi)
        acc = ((pe + po) * sc[None]).sum(dim=-1)
    else:
        sce = sc.repeat_interleave(gsz2, dim=1)  # [out, in/2]: group scale per lane
        lo = (lo.float() * sce).to(op_dtype).float()
        hi = (hi.float() * sce).to(op_dtype).float()
        acc = ye @ lo.T + yo @ hi.T
    return acc.to(y.dtype).reshape(b, s, out_dim)


def body_for(mode: str, in_dim: int, groups: int) -> str:
    """The kernel body a CUDA launch of this shape takes: "mma" (the tensor
    cores) for dense mode and for grouped mode whose group size is a
    multiple of 128 channels, "fma" (the CUDA cores) for grouped mode with
    groups of 32 or 64: a grouped partial must belong to one group, and an
    mma mixes the channels of a whole 128-channel k-block."""
    return "mma" if mode == "dense" or (in_dim // groups) % 128 == 0 else "fma"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.q4_matmul_bf16.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.q4_matmul_bf16, lib.q4_matmul_grouped_mma_bf16, lib.q4_matmul_dense_mma_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.q4_matmul_error_string.argtypes = [i32]
        lib.q4_matmul_error_string.restype = ctypes.c_char_p
    return lib


def q4_matmul(y: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, mode: str = "grouped") -> torch.Tensor:
    """[B, S, in] @ dequant(w[out, in/2], scale[out, G])^T -> [B, S, out].

    CUDA tensors: launches the hand-written kernel (B4 grouped / B5 dense)
    on the current stream, with the body `body_for` names, and counts the
    launch in `q4_matmul.launches` (by mode) and `q4_matmul.launches_by_body`.
    CPU tensors: the plain version in float32 (no launch, no count)."""
    _check_shapes(y, w, scale, mode)
    if y.device.type == "cpu":
        return q4_matmul_plain(y, w, scale, mode, torch.float32)
    if y.device.type != "cuda":
        raise ValueError(f"q4_matmul runs on CUDA or CPU tensors, got {y.device}")
    if w.device != y.device or scale.device != y.device:
        raise ValueError(
            f"q4_matmul operands on different devices: y {y.device}, "
            f"w {w.device}, scale {scale.device}"
        )
    if (y.dtype, w.dtype, scale.dtype) != (torch.bfloat16, torch.int8, torch.float32):
        raise ValueError(
            f"the CUDA q4_matmul kernel takes bf16 y, int8 w, f32 scale; got "
            f"{y.dtype}, {w.dtype}, {scale.dtype}"
        )
    for name, t in (("y", y), ("w", w), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"q4_matmul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"q4_matmul: {name} must be 16-byte aligned")
    b, s, in_dim = y.shape
    out_dim, in_half = w.shape
    g = scale.shape[1]
    if in_dim % 32 or in_half % g or in_dim // g not in KERNEL_GROUP_SIZES:
        raise ValueError(
            f"the CUDA q4_matmul kernel needs in % 32 == 0 and a group size "
            f"of 32 * 2^k channels (k <= 5); got in={in_dim}, group size "
            f"{in_dim // g}"
        )
    body = body_for(mode, in_dim, g)
    out = torch.empty((b, s, out_dim), dtype=y.dtype, device=y.device)
    lib = _bind(_load())
    args = (y.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), b * s, in_dim, out_dim, g)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if body == "fma":
            rc = lib.q4_matmul_bf16(*args, stream)
        elif mode == "dense":
            rc = lib.q4_matmul_dense_mma_bf16(*args, stream)
        else:
            rc = lib.q4_matmul_grouped_mma_bf16(*args, stream)
    if rc != 0:
        msg = lib.q4_matmul_error_string(rc).decode()
        raise RuntimeError(f"q4_matmul kernel launch failed ({body} body): {msg} (cudaError {rc})")
    q4_matmul.launches[mode] += 1
    q4_matmul.launches_by_body[body] += 1
    return out


q4_matmul.launches = {mode: 0 for mode in MODES}
q4_matmul.launches_by_body = {body: 0 for body in BODIES}


def reset_launches() -> None:
    for mode in MODES:
        q4_matmul.launches[mode] = 0
    for body in BODIES:
        q4_matmul.launches_by_body[body] = 0


def _load() -> ctypes.CDLL:
    from .kernel_build import load

    return load("q4_matmul")
