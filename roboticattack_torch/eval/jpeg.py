"""ctypes binding of the port's JPEG round trip (`native/jpeg_roundtrip.cpp`).

`jpeg_roundtrip(rgb)` encodes an RGB uint8 frame as TensorFlow's
`tf.image.encode_jpeg` does (quality 95, 4:2:0 chroma) and decodes it as
`tf.io.decode_image` does (the fast integer IDCT), with no TensorFlow. The
helper is compiled with g++ at first use into the git-ignored
`build/native/`, against the vendored libjpeg headers and Pillow's libjpeg
(`utils/libjpeg.py`), never when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import libjpeg

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                      "jpeg_roundtrip.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
QUALITY = 95  # tf.image.encode_jpeg's default
_lib = None
_lock = threading.Lock()


def build_command(output: str) -> list:
    return ["g++", *CXX_FLAGS, "-o", output, SOURCE, *libjpeg.jpeg_flags()]


def library_path() -> str:
    return libjpeg.hashed_path("jpeg_roundtrip", SOURCE, build_command(""), libjpeg.BUILD_DIR)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(libjpeg.build_library(library_path(), build_command, SOURCE))
            lib.jpeg_roundtrip_rgb.restype = ctypes.c_long
            lib.jpeg_roundtrip_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
            _lib = lib
    return _lib


def jpeg_roundtrip(rgb: np.ndarray, quality: int = QUALITY) -> np.ndarray:
    """uint8 [H, W, 3] -> the same frame after a JPEG encode and decode."""
    src = np.ascontiguousarray(rgb, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected an RGB frame [H, W, 3], got shape {src.shape}")
    out = np.empty_like(src)
    h, w, _ = src.shape
    if load_library().jpeg_roundtrip_rgb(src.ctypes.data, h, w, quality, out.ctypes.data) < 0:
        raise RuntimeError(f"libjpeg failed on a {h}x{w} frame")
    return out
