"""ctypes binding of the native (C++) RLDS/TFRecord reader, the port's own.

`native/rlds_reader.cpp` (shared with the JAX package, used unchanged)
provides the native data plane: threaded-prefetch TFRecord reading with both
CRCs checked, tf.Example wire parsing, and libjpeg decoding with a fused
Lanczos-3 resize — the role TensorFlow's C++ tf.data runtime plays for the
reference. The port compiles it at first use with the flags of
`native/Makefile`, against its own copy of libjpeg's headers and Pillow's
bundled libjpeg (`utils/libjpeg.py`; no system `-ljpeg`), into the
git-ignored `build/native/` at the repository root; the library's name
carries a hash of the source and the build line, so an edit of either
rebuilds it. It never writes under `native/`. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Sequence

import numpy as np

from ..utils import libjpeg

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_REPO, "native", "rlds_reader.cpp")
BUILD_DIR = libjpeg.BUILD_DIR
# native/Makefile's CXXFLAGS and LDFLAGS, with libjpeg from utils/libjpeg.py
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-lpthread",)
_lib = None
_lock = threading.Lock()


def build_command(output: str) -> list:
    return ["g++", *CXX_FLAGS, "-o", output, SOURCE, *libjpeg.jpeg_flags(), *LD_FLAGS]


def library_path() -> str:
    return libjpeg.hashed_path("rlds_reader", SOURCE, build_command(""), BUILD_DIR)


def build_if_needed() -> str:
    """Compile the reader into build/native/ unless this source and build
    line are built there already; returns the library's path."""
    return libjpeg.build_library(library_path(), build_command, SOURCE)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build_if_needed()))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rlds_reader_open.restype = ctypes.c_void_p
    lib.rlds_reader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
    lib.rlds_reader_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rlds_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rlds_free.argtypes = [ctypes.c_void_p]
    lib.rlds_reader_close.argtypes = [ctypes.c_void_p]
    lib.rlds_example_feature.restype = ctypes.c_int
    lib.rlds_example_feature.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rlds_example_feature_count.restype = ctypes.c_int64
    lib.rlds_example_feature_count.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.rlds_example_bytes_at.restype = ctypes.c_int
    lib.rlds_example_bytes_at.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rlds_jpeg_decode.restype = ctypes.c_int
    lib.rlds_jpeg_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rlds_jpeg_decode_resized.restype = ctypes.c_int
    lib.rlds_jpeg_decode_resized.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


class NativeExample:
    """One parsed tf.Example (owns the raw record buffer)."""

    def __init__(self, lib: ctypes.CDLL, buf, length: int):
        self._lib = lib
        self._buf = buf
        self._len = length

    def feature(self, key: str):
        kind = ctypes.c_int()
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        count = ctypes.c_int64()
        rc = self._lib.rlds_example_feature(
            self._buf, self._len, key.encode(), ctypes.byref(kind),
            ctypes.byref(ptr), ctypes.byref(count),
        )
        if rc != 0:
            raise KeyError(f"feature '{key}' not found in example")
        n = count.value
        if kind.value == 1:  # bytes: view into the record (copy out)
            return bytes(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * n)).contents)
        if kind.value == 2:
            arr = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), (n,)
            ).copy()
            self._lib.rlds_free(ptr)
            return arr
        arr = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int64)), (n,)
        ).copy()
        self._lib.rlds_free(ptr)
        return arr

    def feature_count(self, key: str) -> int:
        """Element count of a (repeated) feature; RLDS episodes store one
        bytes element per step."""
        n = self._lib.rlds_example_feature_count(self._buf, self._len, key.encode())
        if n < 0:
            raise KeyError(f"feature '{key}' not found in example")
        return int(n)

    def bytes_at(self, key: str, index: int) -> bytes:
        """One element of a repeated bytes feature (copied out)."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_int64()
        rc = self._lib.rlds_example_bytes_at(
            self._buf, self._len, key.encode(), index, ctypes.byref(ptr),
            ctypes.byref(length),
        )
        if rc != 0:
            raise KeyError(f"bytes feature '{key}'[{index}] not found")
        n = length.value
        return bytes(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * n)).contents)

    def decode_jpeg(self, key: str) -> np.ndarray:
        data = self.feature(key)
        assert isinstance(data, bytes)
        return decode_jpeg(data)

    def close(self):
        if self._buf is not None:
            self._lib.rlds_free(self._buf)
            self._buf = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_jpeg(data: bytes) -> np.ndarray:
    lib = load_library()
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.rlds_jpeg_decode(src, len(data), None, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise ValueError("invalid JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.rlds_jpeg_decode(
        src, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out


def decode_jpeg_resized(data: bytes, size: int) -> np.ndarray:
    """Decode + Lanczos-3 resize to [size, size, 3] in one native call (the
    C++ separable resampler in rlds_reader.cpp — same kernel family as the tf
    path's lanczos3, parity-tested within quantization tolerance)."""
    lib = load_library()
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.rlds_jpeg_decode_resized(
        src, len(data), size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    if rc != 0:
        raise ValueError("JPEG decode failed")
    return out


class NativeRLDSReader:
    """Threaded-prefetch iterator over TFRecord files of tf.Examples."""

    def __init__(self, paths: Sequence[str], prefetch_depth: int = 64):
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.rlds_reader_open(arr, len(paths), prefetch_depth)

    def __iter__(self) -> Iterator[NativeExample]:
        while True:
            length = ctypes.c_int64()
            buf = self._lib.rlds_reader_next(self._handle, ctypes.byref(length))
            if not buf:
                return
            yield NativeExample(self._lib, buf, length.value)

    def close(self):
        if self._handle:
            self._lib.rlds_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
