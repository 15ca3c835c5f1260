"""WidowX (Bridge V2) real-robot evaluation CLI — the reference's
draccus-driven entry point (run_bridgev2_eval.py:37-100) over the port's
policy on a CUDA card.

  python -m roboticattack_torch.cli.eval_bridge --task "put the spoon in the pot" \
      --checkpoint /path/to/openvla-7b --host_ip <robot> --port 5556

or config-file driven:

  python -m roboticattack_torch.cli.eval_bridge --config_path bridge.yaml --task ...

Hardware-gated exactly like the reference: running it needs `widowx_envs`
(physical WidowX + ROS camera stack); parsing/config plumbing works anywhere.
The flags are the JAX CLI's plus `--device cuda|cpu` (default cuda; without
a GPU it raises unless given `--device cpu`).
"""

from __future__ import annotations

import argparse

from ..utils.quant_args import (add_int4_kernel_flag, quantize_arg,
                                resolve_int4_kernel)
from .serve import str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WidowX Bridge V2 rollout driver")
    # BridgeEvalConfig surface (run_bridgev2_eval.py:37-81)
    p.add_argument("--host_ip", default="localhost", type=str)
    p.add_argument("--port", default=5556, type=int)
    p.add_argument("--initial_eep", default="0.3,0.0,0.15", type=str)
    p.add_argument("--blocking", type=str2bool, default=False)
    p.add_argument("--max_episodes", default=50, type=int)
    p.add_argument("--max_steps", default=60, type=int)
    p.add_argument("--control_frequency", default=5.0, type=float)
    p.add_argument("--resize_size", default=224, type=int)
    p.add_argument("--unnorm_key", default="bridge_orig", type=str)
    p.add_argument("--save_dir", default="./bridge_rollouts", type=str)
    # policy + task
    p.add_argument("--task", required=False, default=None, type=str,
                   help="language instruction; prompted interactively if omitted")
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--model", default="openvla-7b", type=str)
    p.add_argument("--center_crop", type=str2bool, default=False)
    # serving levers (models/quant.py, models/decode.py)
    p.add_argument("--quantize", default=None, type=quantize_arg,
                   help="int8 | w8a8 | int4 | int4:<group_size> (w8a8 = int8 "
                        "weights + int8 prefill activations; bare int4 "
                        "resolves the group size per-model)")
    p.add_argument("--kv_cache", default=None, choices=[None, "int8", "int4"])
    add_int4_kernel_flag(p)
    p.add_argument("--jacobi", type=str2bool, default=False,
                   help="draft each control step with the previous step's "
                        "tokens (exact greedy; one verification pass when "
                        "the action repeats — the 5 Hz latency lever)")
    p.add_argument("--config_path", default=None, type=str,
                   help="YAML/JSON BridgeEvalConfig file; CLI flags override")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def apply_config_file(parser: argparse.ArgumentParser, argv) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config_path", default=None)
    known, _ = pre.parse_known_args(argv)
    if not known.config_path:
        return
    from ..eval.bridge import BridgeEvalConfig
    from ..utils.configurate import load_config

    cfg = load_config(BridgeEvalConfig, known.config_path)
    known_flags = {a.dest for a in parser._actions}
    defaults = {}
    for key, value in cfg.__dict__.items():
        if key not in known_flags:
            continue
        if key == "initial_eep":
            value = ",".join(str(v) for v in value)
        defaults[key] = value
    parser.set_defaults(**defaults)


def config_from_args(args) -> "BridgeEvalConfig":
    from ..eval.bridge import BridgeEvalConfig

    eep = tuple(float(v) for v in str(args.initial_eep).split(","))
    return BridgeEvalConfig(
        host_ip=args.host_ip, port=args.port, initial_eep=eep,
        blocking=args.blocking, max_episodes=args.max_episodes,
        max_steps=args.max_steps, control_frequency=args.control_frequency,
        resize_size=args.resize_size, unnorm_key=args.unnorm_key,
        save_dir=args.save_dir, jacobi=args.jacobi,
    )


def main(argv=None):
    parser = build_parser()
    apply_config_file(parser, argv)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    from ..eval.bridge import run_bridge_eval
    from ..eval.policy import load_policy

    task = args.task or input("task instruction: ").strip()
    policy = load_policy(
        args.checkpoint, model_name=args.model,
        unnorm_key=args.unnorm_key, center_crop=args.center_crop,
        quantize=args.quantize, kv_cache=args.kv_cache,
        int4_kernel=resolve_int4_kernel(args.int4_kernel), device=args.device,
    )
    run_bridge_eval(cfg, policy, task)


if __name__ == "__main__":
    main()
