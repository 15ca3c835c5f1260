"""Action-serving CLI: HTTP endpoint over the batched decode on a CUDA card.

  python -m roboticattack_torch.cli.serve --model openvla-7b \
      --quantize int4 --max_batch 8 --port 8000

From a local HF OpenVLA checkpoint directory (safetensors shards,
dataset_statistics.json, and tokenizer files where it ships them):
  python -m roboticattack_torch.cli.serve --checkpoint /path/to/openvla-7b \
      --model openvla-7b --quantize int4 --unnorm_key bridge_orig

Smoke (tiny model, random weights, CPU):
  python -m roboticattack_torch.cli.serve --model vla-tiny --device cpu \
      --max_batch 4 --port 8000

Smoke of the serving options (tiny model, CPU): Jacobi drafts, an int4 KV
cache and visual-token pruning:
  python -m roboticattack_torch.cli.serve --model vla-tiny --device cpu \
      --drafts --kv_cache int4 --visual_tokens 8

The flags are the JAX CLI's (roboticattack_tpu/cli/serve.py), with
`--platform` replaced by `--device cuda|cpu`. Options whose code is not
ported yet (--center_crop, --tp/--dp other than 1) raise
NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse

from .. import not_ported
from ..utils.quant_args import add_int4_kernel_flag, quantize_arg, resolve_int4_kernel


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HTTP action-serving endpoint")
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--model", default="openvla-7b", type=str)
    p.add_argument("--unnorm_key", default=None, type=str)
    p.add_argument("--center_crop", type=str2bool, default=False)
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8000, type=int)
    p.add_argument("--max_batch", default=8, type=int)
    p.add_argument("--max_wait_ms", default=5.0, type=float)
    p.add_argument("--quantize", default=None, type=quantize_arg,
                   help="int8 | w8a8 | int4 | int4:<group_size> (bare int4 "
                        "resolves the group size per model)")
    p.add_argument("--kv_cache", default=None, choices=[None, "int8", "int4"])
    add_int4_kernel_flag(p)
    p.add_argument("--tp", default=1, type=int)
    p.add_argument("--dp", default=1, type=int)
    p.add_argument("--visual_tokens", default=None, type=int)
    p.add_argument("--drafts", action="store_true",
                   help="Jacobi self-speculative decode: clients send the "
                        "previous reply's 'tokens' as 'draft_tokens' and a "
                        "correct draft runs the decode tail in one pass; "
                        "replies carry 'tokens', /healthz adds verify-pass stats")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every batch bucket once at startup")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.tp != 1 or args.dp != 1:
        raise not_ported("--tp/--dp serving", "slice 3: TP and DP")
    import numpy as np

    from ..eval.policy import load_policy
    from ..serving.http import ActionServer

    if args.checkpoint is None and args.model == "openvla-7b":
        print("WARNING: no --checkpoint; random weights (smoke mode)")
    policy = load_policy(
        args.checkpoint, model_name=args.model, unnorm_key=args.unnorm_key,
        center_crop=args.center_crop, quantize=args.quantize,
        kv_cache=args.kv_cache, visual_tokens=args.visual_tokens,
        int4_kernel=resolve_int4_kernel(args.int4_kernel), device=args.device,
    )
    server = ActionServer(
        policy, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, drafts=args.drafts,
    )
    if not args.no_warmup:
        size = policy.cfg.dino.image_size
        print(f"warming up buckets {server.batcher.buckets} ...", flush=True)
        server.batcher.warmup(np.zeros((size, size, 3), np.uint8))
    host, port = server.address
    print(f"serving on http://{host}:{port}  (POST /act, GET /healthz)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
