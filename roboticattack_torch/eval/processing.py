"""Evaluation-time image/prompt processing, without TensorFlow.

  - PrismaticImageProcessor parity: PIL bicubic resize to 224 (PIL is
    imported only when a frame needs resizing; model-sized frames never do);
  - the eval-time center crop 0.9 + resize back (the JAX package's
    `tf.image.crop_and_resize` call), transcribed: `center_crop_resize_tf`;
  - the LIBERO frame: 180-degree rotation, the JPEG round trip of
    `tf.image.encode_jpeg` + `tf.io.decode_image` (`eval/jpeg.py`), and
    `tf.image.resize(..., "lanczos3", antialias=True)` transcribed as
    `lanczos3_resize`, then round and clip;
  - the eval prompt string and `quat2axisangle`.

The transcriptions follow TensorFlow's CPU kernels step by step in float32
(`ScaleAndTranslate`: spans sampled at (i + 0.5) / scale with the kernel
widened by max(1 / scale, 1), weights normalized per output pixel, rows then
columns, each a running float32 sum from zero; `CropAndResize`: bilinear
lerps in float32, then the saturating cast of `convert_image_dtype`). The
Lanczos weights take `sinf` from the C library, as TensorFlow's kernel does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Tuple

import numpy as np

from ..utils.constants import IMAGE_SIZE

_F32 = np.float32
_PI = _F32(3.14159265359)  # the constant of TensorFlow's LanczosKernelFunc
LANCZOS_RADIUS = 3


def resize_bicubic_pil(image: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC -> uint8 [size, size, 3] via PIL bicubic."""
    from PIL import Image

    pil = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    pil = pil.resize((size, size), Image.BICUBIC)
    return np.asarray(pil, np.uint8)


@functools.lru_cache(maxsize=1)
def _sinf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.sinf.restype = ctypes.c_float
    libm.sinf.argtypes = [ctypes.c_float]
    return libm.sinf


def _lanczos(x: _F32, radius: _F32) -> _F32:
    """TensorFlow's LanczosKernelFunc, one float32 value."""
    x = _F32(abs(x))
    if x > radius:
        return _F32(0.0)
    if x <= _F32(1e-3):
        return _F32(1.0)
    sinf = _sinf()
    px = _F32(_PI * x)
    num = _F32(_F32(radius * _F32(sinf(px))) * _F32(sinf(_F32(px / radius))))
    return _F32(num / _F32(_F32(_F32(_PI * _PI) * x) * x))


@functools.lru_cache(maxsize=16)
def lanczos3_spans(out_size: int, in_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(starts [out], weights [out, span]) of one axis of
    ScaleAndTranslate(kernel "lanczos3", antialias, translation 0): output
    pixel i reads input pixels starts[i] + k with weights[i, k] (0 past its
    own span)."""
    radius = _F32(LANCZOS_RADIUS)
    scale = _F32(_F32(out_size) / _F32(in_size))
    inv_scale = _F32(1.0 / float(scale))
    kernel_scale = max(inv_scale, _F32(1.0))
    reach = _F32(radius * kernel_scale)
    span = min(2 * math.ceil(float(reach)) + 1, in_size)
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, span), _F32)
    inv_kernel_scale = _F32(_F32(1.0) / kernel_scale)
    for i in range(out_size):
        sample = _F32(_F32(_F32(i) + _F32(0.5)) * inv_scale)
        if sample < 0 or sample > in_size:
            continue
        lo = min(max(math.ceil(_F32(_F32(sample - reach) - _F32(0.5))), 0), in_size - 1)
        hi = min(max(math.floor(_F32(_F32(sample + reach) - _F32(0.5))), 0), in_size - 1) + 1
        w = [_lanczos(_F32(_F32(_F32(_F32(src) + _F32(0.5)) - sample) * inv_kernel_scale), radius)
             for src in range(lo, hi)]
        total = _F32(0.0)
        for v in w:
            total = _F32(total + v)
        if abs(total) >= 1000.0 * np.finfo(_F32).tiny:
            weights[i, : len(w)] = np.asarray(w, _F32) * _F32(_F32(1.0) / total)
        starts[i] = lo
    return starts, weights


def _gather_axis(x: np.ndarray, starts: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """Resize `x` (float32) along `axis`: a running float32 sum from zero over
    the span, product by product, as TensorFlow's GatherRows/GatherColumns."""
    n = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = len(starts)
    out = np.zeros(x.shape[:axis] + (len(starts),) + x.shape[axis + 1:], _F32)
    for k in range(weights.shape[1]):
        src = starts + k
        w = np.where(src < n, weights[:, k], _F32(0.0)).reshape(shape)
        out += w * np.take(x, np.minimum(src, n - 1), axis=axis)
    return out


def lanczos3_resize(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 or float [H, W, C] -> float32 [size, size, C]:
    `tf.image.resize(image, (size, size), "lanczos3", antialias=True)`."""
    x = np.asarray(image).astype(_F32)
    x = _gather_axis(x, *lanczos3_spans(size, x.shape[0]), axis=0)
    return _gather_axis(x, *lanczos3_spans(size, x.shape[1]), axis=1)


def center_crop_resize_tf(image: np.ndarray, crop_scale: float = 0.9) -> np.ndarray:
    """The eval-time center crop (openvla_utils.py:81-124): crop to
    sqrt(crop_scale) of each side, bilinear resize back to 224, as
    `tf.image.crop_and_resize` of the frame scaled to [0, 1] followed by
    `convert_image_dtype(..., uint8, saturate=True)`."""
    img = np.asarray(image).astype(_F32) * _F32(1.0 / 255.0)
    h, w, _ = img.shape
    side = np.clip(np.sqrt(crop_scale), 0, 1)
    off = (1 - side) / 2
    y1, x1, y2, x2 = (_F32(v) for v in (off, off, off + side, off + side))
    size = IMAGE_SIZE

    def coords(lo, hi, n):
        step = _F32(_F32(_F32(hi - lo) * _F32(n - 1)) / _F32(size - 1))
        pos = np.array([_F32(_F32(lo * _F32(n - 1)) + _F32(_F32(i) * step)) for i in range(size)], _F32)
        if pos.min() < 0 or pos.max() > n - 1:
            raise ValueError("the crop box reaches outside the frame")
        lo_idx = np.floor(pos).astype(np.int64)
        return lo_idx, np.ceil(pos).astype(np.int64), (pos - lo_idx.astype(_F32)).astype(_F32)

    top, bottom, y_lerp = coords(y1, y2, h)
    left, right, x_lerp = coords(x1, x2, w)
    xl = x_lerp[None, :, None]
    tl, tr = img[top][:, left], img[top][:, right]
    bl, br = img[bottom][:, left], img[bottom][:, right]
    upper = tl + (tr - tl) * xl
    lower = bl + (br - bl) * xl
    out = upper + (lower - upper) * y_lerp[:, None, None]
    out = np.clip(out, _F32(0.0), _F32(1.0)) * _F32(255.5)
    return np.clip(out, _F32(0.0), _F32(255.0)).astype(np.uint8)


def libero_frame(agentview_image: np.ndarray, resize_size: int = IMAGE_SIZE) -> np.ndarray:
    """LIBERO obs -> model-ready uint8 frame (libero_utils.py:33-58): rotate
    180, JPEG round trip (the training distribution), lanczos3 resize, round
    (half to even) and clip."""
    from .jpeg import jpeg_roundtrip

    img = jpeg_roundtrip(np.asarray(agentview_image)[::-1, ::-1])
    out = lanczos3_resize(img, resize_size)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def eval_prompt(task_label: str) -> str:
    return f"In: What action should the robot take to {task_label.lower()}?\nOut:"


def quat2axisangle(quat) -> np.ndarray:
    """Quaternion (x, y, z, w) -> exponential-map axis-angle
    (libero_utils.py:77-101, after robosuite's transform_utils)."""
    q = np.asarray(quat, np.float64).copy()
    # clip w to the valid range to survive numerical drift
    q[3] = float(np.clip(q[3], -1.0, 1.0))
    den = math.sqrt(max(1.0 - q[3] * q[3], 0.0))
    if math.isclose(den, 0.0):
        return np.zeros(3)
    return (q[:3] * 2.0 * math.acos(q[3])) / den
