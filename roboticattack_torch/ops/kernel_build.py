"""Build and load the port's hand-written CUDA kernels.

Each source under `roboticattack_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface and loaded
with `ctypes`. Builds happen at first use (or up front through
`build_all`, which starts one `nvcc` per source, all at once) into
`build/torch_kernels/` at the repository root. The library's file name
carries a hash of its source and flags, so an edited source is never served
from a stale build. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# kernel library name -> its source in csrc/
SOURCES = {"q4_matmul": "q4_matmul.cu", "flash_attention": "flash_attention.cu", "norm": "norm.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
        "the CUDA toolkit is needed to build the port's kernels"
    )


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel library that is not built yet, one `nvcc`
    process per source, all started together. Returns, per library, the
    build seconds (0.0 when it was already built) and nvcc's output (the
    `-Xptxas -v` register and shared-memory report). Raises on a failed
    build, with the compiler's output."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.monotonic())
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    failed = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent loader sees old or new, never half
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
