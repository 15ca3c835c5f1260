#!/usr/bin/env python3
"""Variants of the int4 dequant-matmul's tensor-core body, timed on one card.

    python scripts/sweep_q4_mma.py --mode grouped   # B4, and the FMA body
    python scripts/sweep_q4_mma.py --mode dense     # B5
    python scripts/sweep_q4_mma.py --sass           # opcode counts of the build

Each variant of `VARIANTS[mode]` is a set of text replacements in
roboticattack_torch/csrc/q4_matmul.cu ("as is" is the source unchanged). All
variants are built at once (one nvcc each), checked against the plain
version and timed in turns, `--rounds` times, in this one process, at the
OpenVLA-7B projection shapes at m=1 and m=8 as `chip_smoke.phase_kernels`
times them; in grouped mode the FMA body on the same shapes too. One line per
variant: one decoder layer's 7 launches and each shape's time. Compare
variants only within one run. A "diagnostic" variant computes something else
(its error is printed, not checked): "no mma" keeps the loads and drops the
unpacking and the products; "no dequant" runs dense mode with grouped mode's
unpacking alone (raw nibbles into the mma's).

Not part of the smoke run: it is how the constants of csrc/q4_matmul.cu
were chosen. Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import math
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import GROUP, PROJ, SEED, card_line, check_close, device_ms, log, ptxas_report  # noqa: E402
from roboticattack_torch.ops import kernel_build  # noqa: E402
from roboticattack_torch.ops.q4_matmul import _bind, q4_matmul, q4_matmul_plain  # noqa: E402

VARIANTS = {
    "grouped": {
        "as is": {},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
        "1 row tile a warp": {"kMTiles = 2;": "kMTiles = 1;"},
        "L2 prefetch 256B": {"cp.async.cg.shared.global [%0]": "cp.async.cg.shared.global.L2::256B [%0]"},
        "diagnostic: no mma": {
            "kblock_mma(part[mt], wa, wb, b);":
            "part[mt][0] += __uint_as_float((wa.x ^ wa.w ^ wb.x ^ wb.w ^ b[0][0] ^ b[7][1]) & 0x3f800000u);"},
    },
    "dense": {
        "as is": {},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
        "2 row tiles a warp": {"kDenseMTiles = 1;": "kDenseMTiles = 2;"},
        "diagnostic: no dequant": {"kblock_mma<true>(": "kblock_mma<false>("},
    },
}


def variant_sources(mode: str, src: str) -> dict:
    """{tag: the CUDA source with the variant's edits}; raises if an edit's
    text is not in `src`."""
    out = {}
    for tag, edits in VARIANTS[mode].items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise ValueError(f"{mode} variant {tag!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        out[tag] = text
    return out


def build_variants(mode: str) -> dict:
    """Every variant of `mode` built at once; {tag: its loaded library}."""
    texts = variant_sources(mode, (kernel_build.CSRC / "q4_matmul.cu").read_text())
    out_dir = kernel_build.BUILD_DIR / f"{mode}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (tag, text) in enumerate(texts.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for tag, (proc, so) in procs.items():
        build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag!r} failed to build:\n{build_log}")
        mma = [e for e in ptxas_report(build_log).split(" | ") if e.startswith("q4_matmul_mma_kernel")]
        log(f"sweep {mode}: {tag}: {' | '.join(mma)}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def sweep(card: str, mode: str = "grouped", rounds: int = 2) -> None:
    libs = build_variants(mode)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {tag: {} for tag in [*libs, *(["fma body"] if mode == "grouped" else [])]}
    errs = {}
    as_is = kernel_build.load("q4_matmul")
    _bind(as_is)
    try:
        for label, out_dim, in_dim, per_layer in PROJ:
            wbytes = out_dim * in_dim // 2
            nbuf = max(2, math.ceil(200e6 / wbytes))  # past the 50 MB L2, as in phase_kernels
            ws = [torch.randint(-128, 128, (out_dim, in_dim // 2), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(nbuf)]
            scs = [(torch.rand((out_dim, in_dim // GROUP), generator=gen, device="cuda") + 0.5) * 2e-3
                   for _ in range(nbuf)]
            for m in (1, 8):
                y = torch.randn((m, 1, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
                want = q4_matmul_plain(y, ws[0], scs[0], mode, torch.bfloat16)
                for _ in range(rounds):
                    for tag, lib in libs.items():
                        kernel_build._loaded["q4_matmul"] = lib
                        got = q4_matmul(y, ws[0], scs[0], mode=mode)
                        if tag.startswith("diagnostic"):
                            err = (got.float() - want.float()).abs().max().item()
                        else:
                            err = check_close(f"sweep {mode} {tag} {label} m={m}", got, want)
                        errs[tag] = max(errs.get(tag, 0.0), err)
                        ms = device_ms(lambda i: q4_matmul(y, ws[i % nbuf], scs[i % nbuf], mode=mode))
                        times[tag].setdefault((m, label, per_layer), []).append(ms)
                    kernel_build._loaded["q4_matmul"] = as_is
                    if mode != "grouped":
                        continue
                    # the FMA body on the same grouped shapes: the design before
                    # the tensor-core body, through its own entry point

                    def fma(i):
                        out = torch.empty((m, 1, out_dim), dtype=torch.bfloat16, device="cuda")
                        rc = as_is.q4_matmul_bf16(
                            y.data_ptr(), ws[i % nbuf].data_ptr(), scs[i % nbuf].data_ptr(), out.data_ptr(),
                            m, in_dim, out_dim, in_dim // GROUP, torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"fma body launch failed: cudaError {rc}")
                        return out
                    err = check_close(f"sweep fma body {label} m={m}", fma(0), want)
                    errs["fma body"] = max(errs.get("fma body", 0.0), err)
                    times["fma body"].setdefault((m, label, per_layer), []).append(device_ms(fma))
            del ws, scs
            torch.cuda.empty_cache()
    finally:
        kernel_build._loaded["q4_matmul"] = as_is
    for tag, t in times.items():
        parts = []
        for m in (1, 8):
            rows = [(label, per_layer, v) for (mm, label, per_layer), v in t.items() if mm == m]
            layer = [sum(per_layer * v[r] for _, per_layer, v in rows) for r in range(rounds)]
            parts.append(f"m={m}: layer ms {[round(x, 5) for x in layer]} ("
                         + ", ".join(f"{label} {[round(x, 5) for x in v]}" for label, _, v in rows) + ")")
        log(f"sweep {mode}: {tag}: max_abs_err {errs[tag]:.4g}; " + "; ".join(parts) + f" [{card}]")


def sass_counts(lib: str = "q4_matmul", match: str = "mma_kernel") -> None:
    """Static opcode counts of each kernel of a built library whose name
    contains `match`, from `cuobjdump -sass` (the toolkit's, beside nvcc):
    what the compiler made of a kernel body."""
    kernel_build.load(lib)
    cuobjdump = os.path.join(os.path.dirname(kernel_build._nvcc()), "cuobjdump")
    so = str(kernel_build.library_path(lib))
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if match not in name:
            continue
        ops = collections.Counter(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", chunk))
        log(f"sass {name}: {sum(ops.values())} instructions: "
            + ", ".join(f"{op} {n}" for op, n in ops.most_common(24)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(VARIANTS), default="grouped")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", action="store_true", help="print opcode counts instead of timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_q4_mma: CUDA is not available", file=sys.stderr)
        return 1
    if args.sass:
        sass_counts()
    else:
        sweep(card_line(), args.mode, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
