"""LIBERO evaluation CLI — the reference's flag surface
(run_libero_eval_args_geo_batch.py:304-341) over the port's policy on a
CUDA card.

  python -m roboticattack_torch.cli.eval_libero --task_suite_name libero_spatial \
      --patchroot run/tma/<id>/last/patch.pt --x 120 --y 160 \
      --checkpoint /path/to/openvla-7b-finetuned-libero-spatial

Smoke on the CPU (tiny model, random weights; LIBERO must be importable):
  python -m roboticattack_torch.cli.eval_libero --model vla-tiny --device cpu \
      --num_trials_per_task 1

Tensor- and data-parallel policy calls, one process a rank:
  torchrun --nproc_per_node 4 -m roboticattack_torch.cli.eval_libero \
      --checkpoint /path/to/openvla-7b --quantize int4 --tp 4 --batch_trials 8
Rank 0 runs the lockstep episodes and writes every file; the other ranks
follow its policy calls (serving/ranks.py). Each rank prints one
`serving rank r/W: {json}` line at the end.

The flags are the JAX CLI's (roboticattack_tpu/cli/eval_libero.py) plus
`--device cuda|cpu` (default cuda; without a GPU it raises unless given
`--device cpu`).
"""

from __future__ import annotations

import argparse

from ..utils.quant_args import add_int4_kernel_flag, quantize_arg, resolve_int4_kernel
from .serve import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Closed-loop LIBERO eval with adversarial patch")
    p.add_argument("--task_suite_name", default="libero_spatial",
                   choices=["libero_spatial", "libero_object", "libero_goal",
                            "libero_10", "libero_90"])
    p.add_argument("--patchroot", default=None, type=str, help="patch.pt/.npy; omit for clean eval")
    p.add_argument("--x", default=0, type=int)
    p.add_argument("--y", default=0, type=int)
    p.add_argument("--angle", default=0.0, type=float)
    p.add_argument("--shx", default=0.0, type=float)
    p.add_argument("--shy", default=0.0, type=float)
    p.add_argument("--num_trials_per_task", default=50, type=int)
    p.add_argument("--batch_trials", default=1, type=int,
                   help=">1 runs that many trials as lockstep simultaneous "
                        "envs sharing one batched policy call per step "
                        "(~N envs for one env's decode wall-clock; costs N "
                        "live simulator instances of host RAM)")
    p.add_argument("--center_crop", type=str2bool, default=False)
    p.add_argument("--seed", default=7, type=int)
    p.add_argument("--output", default="./experiments/logs", type=str)
    p.add_argument("--save_videos", type=str2bool, default=False)
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--model", default="openvla-7b", type=str)
    p.add_argument("--unnorm_key", default=None, type=str)
    p.add_argument("--quantize", default=None, type=quantize_arg,
                   help="int8 | w8a8 | int4 | int4:<group_size> (w8a8 = int8 "
                        "weights + int8 prefill activations; bare int4 "
                        "resolves the group size per model)")
    p.add_argument("--kv_cache", default=None, choices=[None, "int8", "int4"],
                   help="int8 or packed int4 KV cache")
    add_int4_kernel_flag(p)
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel policy calls over this many torchrun ranks")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel policy calls: --batch_trials rows split "
                        "over this many replicas (composes with --tp; torchrun "
                        "--nproc_per_node dp*tp)")
    p.add_argument("--visual_tokens", default=None, type=int,
                   help="keep only the k most salient patch tokens before "
                        "the LLM (LOSSY; run a clean-vs-pruned A/B first)")
    p.add_argument("--jacobi", type=str2bool, default=False,
                   help="Jacobi self-speculative decode: draft each step "
                        "with the previous step's tokens (greedy; the "
                        "6-step decode tail usually collapses to one "
                        "verification pass in a control loop)")
    p.add_argument("--config_path", default=None, type=str,
                   help="YAML/JSON LiberoEvalConfig file (draccus-style; the "
                        "reference's clean eval is config-file driven, "
                        "run_libero_eval.py) — CLI flags override file values")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def apply_config_file(parser: argparse.ArgumentParser, argv) -> None:
    """Pre-scan for --config_path and fold the file's LiberoEvalConfig values
    in as parser defaults (precedence: CLI flag > file > built-in default)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config_path", default=None)
    known, _ = pre.parse_known_args(argv)
    if not known.config_path:
        return
    from ..eval.libero import LiberoEvalConfig
    from ..utils.configurate import load_config

    cfg = load_config(LiberoEvalConfig, known.config_path)
    known_flags = {a.dest for a in parser._actions}
    parser.set_defaults(**{
        k: v for k, v in cfg.__dict__.items() if k in known_flags
    })
    if "output_dir" in cfg.__dict__ and "output" in known_flags:
        parser.set_defaults(output=cfg.output_dir)


def main(argv=None):
    parser = build_parser()
    apply_config_file(parser, argv)
    args = parser.parse_args(argv)
    from ..eval.libero import LiberoEvalConfig, eval_libero
    from ..eval.policy import load_policy
    from ..parallel import make_serving_mesh
    from ..serving import ranks

    mesh = make_serving_mesh(tp=args.tp, dp=args.dp, device=args.device)
    lead = mesh is None or mesh.rank == 0
    if args.checkpoint is None and args.model == "openvla-7b" and lead:
        print("WARNING: no --checkpoint; random weights (smoke mode)")
    if args.dp > 1 and args.batch_trials % args.dp and lead:
        print(f"WARNING: --dp {args.dp} does not divide --batch_trials "
              f"{args.batch_trials}; policy calls serve replicated "
              f"(no dp speedup)", flush=True)
    policy = load_policy(
        args.checkpoint, model_name=args.model,
        unnorm_key=args.unnorm_key, center_crop=args.center_crop,
        quantize=args.quantize, kv_cache=args.kv_cache,
        visual_tokens=args.visual_tokens,
        int4_kernel=resolve_int4_kernel(args.int4_kernel), device=args.device, mesh=mesh,
    )
    cfg = LiberoEvalConfig(
        task_suite_name=args.task_suite_name,
        num_trials_per_task=args.num_trials_per_task,
        patchroot=args.patchroot,
        x=args.x, y=args.y, angle=args.angle, shx=args.shx, shy=args.shy,
        center_crop=args.center_crop, seed=args.seed,
        output_dir=args.output, save_videos=args.save_videos,
        unnorm_key=args.unnorm_key, batch_trials=args.batch_trials,
        jacobi=args.jacobi,
    )
    result = ranks.run(policy, lambda: eval_libero(cfg, policy))
    if lead:
        successes, episodes = result
        print(f"success rate: {successes}/{episodes}")
    if mesh is not None:
        from ..parallel import distributed

        ranks.print_rank_report(policy)
        distributed.shutdown()


if __name__ == "__main__":
    main()
