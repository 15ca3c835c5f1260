"""libjpeg for the port's C++ helpers, and their build.

The port carries libjpeg's ABI-62 headers (`roboticattack_torch/native/include`)
and links each helper by full path, with an rpath, to the libjpeg that Pillow
bundles (`pillow.libs/libjpeg-*.so.62*` next to the `PIL` package). So the
same library decodes on every machine the port runs on, and neither a system
libjpeg nor `jpeglib.h` is needed. There is no fallback: without Pillow's
library the build raises.

Libraries are built with g++ at first use into the git-ignored `build/native/`
at the repository root, never when a module is imported. A library's file name
carries a hash of its source, the vendored headers and its build line, so an
edited source or header or a changed flag is never served from a stale build.
"""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess
import tempfile
from typing import Callable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INCLUDE_DIR = os.path.join(_PKG, "native", "include")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")


def pillow_libjpeg() -> str:
    """The full path of Pillow's bundled libjpeg (ABI 62). Raises
    FileNotFoundError when Pillow ships none."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(PIL.__file__))), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so.62*")))
    if not found:
        raise FileNotFoundError(
            f"no libjpeg-*.so.62* in {libs}: the port links its JPEG code to Pillow's "
            "bundled libjpeg, and this Pillow ships none"
        )
    return found[0]


def jpeg_flags() -> List[str]:
    """The g++ arguments that compile against the vendored headers and link
    Pillow's libjpeg by full path with an rpath to its directory."""
    lib = pillow_libjpeg()
    return ["-I", INCLUDE_DIR, lib, f"-Wl,-rpath,{os.path.dirname(lib)}"]


def hashed_path(stem: str, source: str, command: List[str], build_dir: str) -> str:
    """`<build_dir>/lib<stem>-<hash>.so`, the hash over the bytes of the
    source and of every vendored header, and the build line."""
    h = hashlib.sha1()
    for path in [source] + sorted(glob.glob(os.path.join(INCLUDE_DIR, "*.h"))):
        with open(path, "rb") as f:
            h.update(f.read() + b"\0")
    h.update("\0".join(command).encode())
    return os.path.join(build_dir, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build_library(target: str, command: Callable[[str], List[str]], source: str) -> str:
    """Run `command(output)` unless `target` exists; returns `target`.
    Concurrent builders (other processes) each compile into a temporary file
    and rename it into place, so a loader never sees a half-written library.
    A failed build raises with the compiler's output."""
    if os.path.exists(target):
        return target
    out_dir = os.path.dirname(target)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {source} failed (g++ exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target
