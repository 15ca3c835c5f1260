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

Tensor- and data-parallel serving, one process a rank (the JAX CLI drives
a dp x tp mesh from one process):
  torchrun --nproc_per_node 2 -m roboticattack_torch.cli.serve \
      --checkpoint /path/to/openvla-7b --quantize int4 --tp 2
  torchrun --nproc_per_node 4 -m roboticattack_torch.cli.serve \
      --checkpoint /path/to/openvla-7b --quantize int4 --dp 2 --tp 2
Rank 0 binds the port and runs the batcher and the warmup; the other ranks
follow each of its decodes (serving/ranks.py) and exit 0 when it stops.
Each rank prints one `serving rank r/W: {json}` line at the end (its load
and run peaks, each decode's wall ms and int4-kernel (B4) launches).

The flags are the JAX CLI's (roboticattack_tpu/cli/serve.py), with
`--platform` replaced by `--device cuda|cpu`.
"""

from __future__ import annotations

import argparse
import os

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
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel serving: Megatron splits of the "
                        "weights over this many torchrun ranks")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel serving: batch rows split over this "
                        "many replicas; composes with --tp as a dp x tp grid "
                        "(torchrun --nproc_per_node dp*tp)")
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
    from ..eval.policy import load_policy
    from ..parallel import make_serving_mesh
    from ..serving import ranks
    from ..serving.batcher import default_buckets

    mesh = make_serving_mesh(tp=args.tp, dp=args.dp, device=args.device)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None and args.dp > 1 and lead:
        bad = [b for b in default_buckets(args.max_batch) if b % args.dp]
        if bad:
            print(f"WARNING: --dp {args.dp} does not divide buckets {bad}; "
                  f"those batches serve replicated (no dp speedup)", flush=True)
    if args.checkpoint is None and args.model == "openvla-7b" and lead:
        print("WARNING: no --checkpoint; random weights (smoke mode)")
    policy = load_policy(
        args.checkpoint, model_name=args.model, unnorm_key=args.unnorm_key,
        center_crop=args.center_crop, quantize=args.quantize,
        kv_cache=args.kv_cache, visual_tokens=args.visual_tokens,
        int4_kernel=resolve_int4_kernel(args.int4_kernel), device=args.device, mesh=mesh,
    )
    if mesh is not None and lead:
        print(f"rank 0 of {mesh.world} (pid {os.getpid()}) serves; the other ranks follow its decodes",
              flush=True)
    ranks.run(policy, lambda: serve(policy, args))
    if mesh is not None:
        from ..parallel import distributed

        ranks.print_rank_report(policy)
        distributed.shutdown()


def serve(policy, args) -> None:
    """The front end: the batcher and the HTTP server over `policy` (on
    rank 0 alone under a mesh), until interrupted."""
    import numpy as np

    from ..serving.http import ActionServer

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
