"""The one `--quantize` grammar shared by every serving surface.

'int8' | 'w8a8' | 'int4' | 'int4:<group_size>' — parsed here so the serving
CLI and `load_policy` agree. Free of torch and model imports, so a CLI can
validate its flags at parse time without loading the model stack.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple


def parse_quantize(quantize: Optional[str]) -> Tuple[Optional[str], Optional[int]]:
    """'int8' | 'w8a8' | 'int4' | 'int4:<group_size>' | None ->
    (mode, group_size | None). group_size None = auto: VLAPolicy resolves it
    per model via models.quant.int4_group_size_for. 'w8a8' = int8 weights +
    dynamic per-token int8 prefill activations."""
    if quantize is None:
        return None, None
    if quantize in ("int8", "w8a8", "int4"):
        return quantize, None
    if quantize.startswith("int4:"):
        try:
            gs = int(quantize.split(":", 1)[1])
        except ValueError:
            gs = 0
        if gs <= 0:
            raise ValueError(
                f"quantize={quantize!r}: group size must be a positive int"
            )
        return "int4", gs
    raise ValueError(
        f"quantize={quantize!r}; supported: 'int8', 'w8a8', 'int4', "
        f"'int4:<group_size>'"
    )


def resolve_quantize(
    quantize: Optional[str],
) -> Tuple[Optional[str], Optional[str], Optional[int]]:
    """parse_quantize plus the w8a8 split, in one place: ->
    (weights_mode | None, act_quant | None, group_size | None), where
    weights_mode is what quantize_decode_params takes ('int8' | 'int4') and
    act_quant is what greedy_decode_actions takes ('int8' for the w8a8
    prefill)."""
    mode, gs = parse_quantize(quantize)
    if mode == "w8a8":
        return "int8", "int8", gs
    return mode, None, gs


def parse_suffixes(suffixes, context: str = ""):
    """The once-each serving-lever suffixes of the acceptance gate's quant
    modes (models/verify.py parse_quant_mode): kv8|kv4 (KV-cache
    quantization), vt<k> (visual-token pruning) and qk (the CUDA int4
    dequant-matmul decode tail) -> (kv_cache | None, visual_tokens | None,
    qk: bool)."""
    kv = vt = None
    qk = False
    for s in suffixes:
        if s in ("kv8", "kv4") and kv is None:
            kv = {"kv8": "int8", "kv4": "int4"}[s]
        elif s.startswith("vt") and s[2:].isdigit() and int(s[2:]) >= 1 and vt is None:
            vt = int(s[2:])
        elif s == "qk" and not qk:
            qk = True
        else:
            raise ValueError(f"{context}unknown suffix {s!r} (kv8|kv4 / vt<k> / qk, once each)")
    return kv, vt, qk


def add_int4_kernel_flag(parser) -> None:
    """The `--int4_kernel` flag of the serving CLI: auto|on|off ->
    resolve_int4_kernel maps to VLAPolicy's int4_kernel param (None = auto:
    route the int4 decode tail through the CUDA dequant-matmul kernel,
    ops/q4_matmul.py, when the policy runs on a CUDA device)."""
    parser.add_argument(
        "--int4_kernel", default="auto", choices=["auto", "on", "off"],
        help="CUDA int4 dequant-matmul decode tail "
             "(auto = int4 weights on a CUDA device)",
    )


def resolve_int4_kernel(s: str):
    """'auto'|'on'|'off' -> None|True|False (VLAPolicy int4_kernel)."""
    return {"auto": None, "on": True, "off": False}[s]


def quantize_arg(s: str) -> str:
    """argparse `type=` validator for --quantize flags: fail at parse time
    with the grammar instead of deep inside policy construction.
    ArgumentTypeError (not ValueError) so argparse prints the grammar
    message rather than 'invalid quantize_arg value'."""
    try:
        parse_quantize(s)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return s
