#!/usr/bin/env python3
"""Variants of the int4 dequant-matmul's tensor-core body, timed on one card.

    python scripts/sweep_q4_mma.py --mode grouped   # B4
    python scripts/sweep_q4_mma.py --mode grouped --m 8,56 --group 64 --tp 4
    python scripts/sweep_q4_mma.py --mode dense     # B5
    python scripts/sweep_q4_mma.py --sass           # opcode counts of the build

Each variant of `VARIANTS[mode]` is a set of text replacements in
roboticattack_torch/csrc/q4_matmul.cu ("as is" is the source unchanged). All
variants are built at once (one nvcc each), checked against the plain
version and timed in turns, `--rounds` times, in this one process, at the
OpenVLA-7B projection shapes (`--tp 2` or `4`: a tensor-parallel rank's
shapes) with groups of `--group` channels, at each m of `--m` (1 and 8 by
default; 56 is the Jacobi pass at bs 8), as `chip_smoke.phase_kernels` times
them. One line per variant: one decoder layer's 7 launches and each shape's
time. Compare variants only within one run. A "diagnostic" variant computes
something else (its error is printed, not checked): "no mma" keeps the loads
and the unpacking of grouped mode and drops the products; "no dequant" runs
dense mode with grouped mode's unpacking alone (raw nibbles into the
mma's). `--only` keeps the named variants; `--baseline FILE` adds a source
file with the same C entries (an earlier commit's csrc/q4_matmul.cu, unpacked
under build/) as one more variant, to compare two versions in one process.

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

from chip_smoke import GROUP, PROJ, SEED, TP_SHAPES, card_line, check_close, device_ms, log, ptxas_report  # noqa: E402
from roboticattack_torch.ops import kernel_build  # noqa: E402
from roboticattack_torch.ops.q4_matmul import _bind, q4_matmul, q4_matmul_plain  # noqa: E402

VARIANTS = {
    "grouped": {
        "as is": {},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
        "4 stages": {"kStages = 2;": "kStages = 4;"},
        "1 row tile a warp at m <= 8": {"kMTiles = 2;": "kMTiles = 1;"},
        "2 row tiles a warp at m > 8": {"kWideMTiles = 1;": "kWideMTiles = 2;"},
        "K slices of >= 2 units at m > 8": {"kMinSliceUnits = 4;": "kMinSliceUnits = 2;"},
        "8 warps a block at m > 8": {"wide_tiles * 2 < sms ?": "wide_tiles * 2 < 0 ?"},
        "two blocks an SM at 7 n-tiles": {"kNT >= 7 ? 1 : kMmaWarpsPerSm": "kNT >= 8 ? 1 : kMmaWarpsPerSm",
                                          "const long per_sm = nt >= 7 ? 1 : 2;": "const long per_sm = nt >= 8 ? 1 : 2;"},
        "8 n-tiles at m = 56": {"constexpr int kNTs[] = {1, 2, 4, 7, 8};": "constexpr int kNTs[] = {1, 2, 4, 8, 8};"},
        "K slices of >= 8 units at m > 8": {"kMinSliceUnits = 4;": "kMinSliceUnits = 8;"},
        "no cluster at m > 8": {"kMaxCluster = 8;": "kMaxCluster = 1;"},
        "L2 prefetch 256B": {"cp.async.cg.shared.global [%0]": "cp.async.cg.shared.global.L2::256B [%0]"},
        "diagnostic: no activation copy at m > 8": {
            "if (j < n_st) issue(st_begin + j, j), issue_act(st_begin + j, j);": "if (j < n_st) issue(st_begin + j, j);",
            "        issue_act(st_begin + j + kStages - 1, buf);": ""},
        "diagnostic: no cluster sum at m > 8": {"if (k < slices) p[k] = reinterpret_cast": "if (k < 1) p[k] = reinterpret_cast"},
        "diagnostic: no mma": {
            "word_mma<false>(part[mt][0], wa[q], wb[q], b[q], 0.f, 0.f);":
            "part[mt][0][0] += __uint_as_float((s4_pair<0>(wa[q]) ^ s4_pair<12>(wb[q]) ^ b[q][0][0] ^ b[q][1][1])"
            " & 0x3f800000u);",
            "mma_bf16(part[mt][nt], a[0][mt], yq.x, yq.y);":
            "part[mt][nt][0] += __uint_as_float((a[0][mt][0] ^ a[0][mt][3] ^ yq.x ^ yq.y) & 0x3f800000u);",
            "mma_bf16(part[mt][nt], a[1][mt], yq.z, yq.w);":
            "part[mt][nt][1] += __uint_as_float((a[1][mt][1] ^ a[1][mt][2] ^ yq.z ^ yq.w) & 0x3f800000u);"},
    },
    "dense": {
        "as is": {},
        "3 stages": {"kStages = 2;": "kStages = 3;"},
        "2 row tiles a warp": {"kDenseMTiles = 1;": "kDenseMTiles = 2;"},
        "diagnostic: no dequant": {"  if constexpr (!kDense) {\n    return p;": "  if constexpr (true) {\n    return p;"},
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


def build_variants(mode: str, only=None, baseline=None) -> dict:
    """Every variant of `mode` (those named in `only`, if given; and the
    source file `baseline` as the variant "baseline") built at once; {tag:
    its loaded library}."""
    texts = variant_sources(mode, (kernel_build.CSRC / "q4_matmul.cu").read_text())
    if only:
        texts = {tag: text for tag, text in texts.items() if tag in only}
    if baseline:
        with open(baseline) as f:
            texts["baseline"] = f.read()
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


def sweep(card: str, mode: str = "grouped", rounds: int = 2, m_rows=(1, 8), gs: int = GROUP, tp: int = 1,
          only=None, baseline=None) -> None:
    libs = build_variants(mode, only, baseline)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = PROJ if tp == 1 else TP_SHAPES[tp][1]
    times = {tag: {} for tag in libs}
    errs = {}
    as_is = kernel_build.load("q4_matmul")
    _bind(as_is)
    try:
        for label, out_dim, in_dim, per_layer in shapes:
            wbytes = out_dim * in_dim // 2
            nbuf = max(2, math.ceil(200e6 / wbytes))  # past the 50 MB L2, as in phase_kernels
            ws = [torch.randint(-128, 128, (out_dim, in_dim // 2), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(nbuf)]
            scs = [(torch.rand((out_dim, in_dim // gs), generator=gen, device="cuda") + 0.5) * 2e-3
                   for _ in range(nbuf)]
            for m in m_rows:
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
            del ws, scs
            torch.cuda.empty_cache()
    finally:
        kernel_build._loaded["q4_matmul"] = as_is
    for tag, t in times.items():
        parts = []
        for m in m_rows:
            rows = [(label, per_layer, v) for (mm, label, per_layer), v in t.items() if mm == m]
            layer = [sum(per_layer * v[r] for _, per_layer, v in rows) for r in range(rounds)]
            parts.append(f"m={m}: layer ms {[round(x, 5) for x in layer]} ("
                         + ", ".join(f"{label} {[round(x, 5) for x in v]}" for label, _, v in rows) + ")")
        log(f"sweep {mode} groups of {gs}{f' tp {tp}' if tp > 1 else ''}: {tag}: max_abs_err {errs[tag]:.4g}; "
            + "; ".join(parts) + f" [{card}]")


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
    ap.add_argument("--m", default="1,8", help="comma-separated activation row counts")
    ap.add_argument("--group", type=int, default=GROUP, help="int4 group size (channels)")
    ap.add_argument("--tp", type=int, default=1, choices=(1, 2, 4), help="a tensor-parallel rank's shapes")
    ap.add_argument("--only", default="", help="comma-separated variant tags to build (default: all)")
    ap.add_argument("--baseline", default=None, help="a q4_matmul.cu to time as one more variant")
    ap.add_argument("--sass", action="store_true", help="print opcode counts instead of timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_q4_mma: CUDA is not available", file=sys.stderr)
        return 1
    if args.sass:
        sass_counts()
    else:
        sweep(card_line(), args.mode, args.rounds, tuple(int(x) for x in args.m.split(",")), args.group, args.tp,
              [t for t in args.only.split(",") if t], args.baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
