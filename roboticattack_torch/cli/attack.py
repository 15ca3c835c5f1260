"""Attack CLI of the port: the JAX package's `cli/attack.py` flag surface over
the PyTorch runner, on one CUDA device (or the CPU with `--device cpu`).

Examples:
  python -m roboticattack_torch.cli.attack --attack uada --model openvla-7b \\
      --dataset dummy --iter 3 --innerLoop 2 --bs 8 --pad_to 32
  python -m roboticattack_torch.cli.attack --attack tma --maskidx 6 \\
      --model vla-tiny --device cpu --dataset dummy --iter 3 --innerLoop 2 --bs 2

Weights are random, drawn from --seed on the device. --checkpoint, any
--dataset but dummy (with --file_layer, --stats_json, --data_dir),
--data_parallel / --ddp_semantics exact and --profile raise: they are not
ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

import argparse
import os
import uuid

from .. import not_ported


def list_of_ints(arg: str):
    return list(map(int, arg.split(",")))


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if value.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="OpenVLA adversarial patch attacks (PyTorch + CUDA)")
    p.add_argument("--attack", default="tma", choices=["tma", "uada", "upa", "upa_guide", "upa_negce"])
    # --- reference flag surface ---
    p.add_argument("--maskidx", default="0", type=list_of_ints)
    p.add_argument("--lr", default=2e-3, type=float)
    p.add_argument("--server", default=".", type=str, help="output root prefix")
    p.add_argument("--iter", default=2000, type=int)
    p.add_argument("--accumulate", default=1, type=int)
    p.add_argument("--bs", default=8, type=int)
    p.add_argument("--warmup", default=20, type=int)
    p.add_argument("--tags", nargs="+", default=["cuda"])
    p.add_argument("--filterGripTrainTo1", type=str2bool, nargs="?", default=False)
    p.add_argument("--geometry", type=str2bool, nargs="?", default=True)
    p.add_argument("--patch_size", default="3,50,50", type=list_of_ints)
    p.add_argument("--wandb_project", default="false", type=str)
    p.add_argument("--wandb_entity", default=None, type=str)
    p.add_argument("--innerLoop", default=50, type=int)
    p.add_argument("--dataset", default="bridge_orig", type=str)
    p.add_argument("--resize_patch", type=str2bool, default=False)
    p.add_argument("--targetAction", default=0, type=float)            # TMA
    p.add_argument("--reverse_direction", type=str2bool, default=True)  # UPA
    p.add_argument("--alpha", default=0.8, type=float)                  # UPA
    p.add_argument("--belta", default=0.2, type=float)                  # UPA (sic)
    p.add_argument("--MSE_weights", default=5.0, type=float)            # UADA DDP
    p.add_argument("--seed", default=42, type=int)
    # --- additions of the JAX package ---
    p.add_argument("--model", default=None, type=str,
                   help="config name (e.g. openvla-7b, vla-tiny); inferred from --dataset if unset")
    p.add_argument("--checkpoint", default=None, type=str,
                   help="local HF OpenVLA checkpoint dir (not ported)")
    p.add_argument("--data_parallel", type=str2bool, default=False,
                   help="data-parallel attack over the local devices (not ported)")
    p.add_argument("--file_layer", default="tf", choices=["tf", "tfrecord", "native"],
                   help="RLDS reader of a real dataset (not ported)")
    p.add_argument("--stats_json", default=None, type=str,
                   help="dataset_statistics.json of a real dataset (not ported)")
    p.add_argument("--data_dir", default=None, type=str, help="TFDS data root (not ported)")
    p.add_argument("--shuffle_buffer", default=100_000, type=int,
                   help="frame shuffle-buffer size of a real dataset")
    p.add_argument("--ddp_semantics", default="gspmd", choices=["gspmd", "exact"],
                   help="gradient sync of the data-parallel attack (not ported)")
    p.add_argument("--eval_every", default=None, type=int)
    p.add_argument("--eval_batches", default=None, type=int)
    p.add_argument("--output", default=None, type=str, help="run dir (default run/<attack>/<uuid>)")
    p.add_argument("--profile", default=None, type=str, help="trace one step to this dir (not ported)")
    p.add_argument("--resume", default=None, type=str,
                   help="resume patch + optimizer state from a previous run dir")
    p.add_argument("--pad_to", default=32, type=int,
                   help="fixed text pad length (multimodal seq = 256 + pad_to)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default) raises without a GPU; 'cpu' runs the plain "
                        "versions of every kernel")
    return p


def dataset_to_model(dataset: str) -> str:
    if "bridge_orig" in dataset or dataset == "dummy":
        return "openvla-7b"
    for suite in ("libero_spatial", "libero_object", "libero_goal", "libero_10"):
        if suite in dataset:
            return f"openvla-7b-finetuned-{suite.replace('_', '-', 1)}"
    raise ValueError(f"Invalid dataset {dataset}")


def resolve_objective(args) -> str:
    if args.attack == "upa" and not args.reverse_direction:
        return "upa_negce"
    return args.attack


def check_ported(args) -> None:
    """Raise for every option whose code is not ported yet."""
    if args.checkpoint:
        raise not_ported("--checkpoint (HF checkpoint loading)", "slice 4: checkpoints")
    if args.dataset != "dummy":  # the dummy source reads no files: --file_layer does not apply
        raise not_ported(f"--dataset {args.dataset} / --file_layer {args.file_layer} (RLDS data)",
                         "slice 6: data")
    if args.data_parallel or args.ddp_semantics == "exact":
        raise not_ported("--data_parallel / --ddp_semantics exact", "slice 2 item 7: data-parallel attack")
    if args.profile:
        raise not_ported("--profile", "slice 7: training and infra (utils/profiling.py)")


def make_data(args, cfg):
    """Train/val batch iterators of the dummy source (numpy batches)."""
    from ..data import batch_iterator, dummy_frame_iterator
    from ..utils.prompting import WordStubTokenizer

    tok = WordStubTokenizer()
    image_size = cfg.dino.image_size
    train = batch_iterator(dummy_frame_iterator(tok, image_size=image_size, seed=args.seed),
                           args.bs, pad_to=args.pad_to)
    # val batch size fixed at 8, as the reference's val loader
    val = batch_iterator(dummy_frame_iterator(tok, image_size=image_size, seed=args.seed + 1),
                         8, pad_to=args.pad_to)
    return train, val


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    import torch

    from ..attacks.attacker import AttackConfig, OpenVLAAttacker
    from ..eval.policy import resolve_device
    from ..models import get_config
    from ..models.vlm import init_vla_params
    from ..utils.tracking import Tracker

    device = resolve_device(args.device)
    exp_id = str(uuid.uuid4())
    model_name = args.model or dataset_to_model(args.dataset)
    cfg = get_config(model_name)
    objective = resolve_objective(args)
    out_dir = args.output or os.path.join(args.server, "run", objective, exp_id)
    os.makedirs(out_dir, exist_ok=True)

    target = "".join(str(i) for i in args.maskidx)
    run_name = (
        f"{args.dataset}_{model_name}_GA{args.accumulate}_lr{args.lr:.0e}_iter{args.iter}"
        f"_warmup{args.warmup}_filterGripTrainTo1{args.filterGripTrainTo1}_target{target}"
        f"_inner_loop{args.innerLoop}_geometry{args.geometry}_patch_size{args.patch_size}"
        f"_seed{args.seed}-{exp_id}"
    )
    tracker = Tracker(
        out_dir, run_name=run_name, wandb_project=args.wandb_project,
        wandb_entity=args.wandb_entity, tags=args.tags,
        config=dict(iteration=args.iter, learning_rate=args.lr,
                    attack_target=args.maskidx, accumulate_steps=args.accumulate),
    )
    print(f"exp_id:{exp_id}\nrun dir: {out_dir}\nmodel: {model_name} ({cfg.name}) on {device}")
    if cfg.name.startswith("openvla"):
        print("WARNING: no --checkpoint given; using random weights (smoke mode)")
    params = init_vla_params(torch.Generator(device=device).manual_seed(args.seed), cfg)

    attack = AttackConfig(
        objective=objective,
        maskidx=args.maskidx,
        lr=args.lr,
        num_iter=args.iter,
        accumulate_steps=args.accumulate,
        batch_size=args.bs,
        warmup=args.warmup,
        filter_grip_train_to_1=args.filterGripTrainTo1,
        geometry=args.geometry,
        patch_size=args.patch_size,
        inner_loop=args.innerLoop,
        resize_patch=args.resize_patch,
        target_action=args.targetAction,
        mse_weight=args.MSE_weights,
        add_inverse_ce=True,
        upa_alpha=args.alpha,
        upa_beta=args.belta,
        eval_every=args.eval_every or 100,
        eval_batches=args.eval_batches or (1000 if objective == "uada" else 100),
        seed=args.seed,
    )
    train, val = make_data(args, cfg)
    runner = OpenVLAAttacker(params, cfg, out_dir, attack, tracker=tracker)
    result = runner.run(train, val, resume_from=args.resume)
    tracker.close()
    print(f"Attack done! best {attack.objective} val metric: {result.best_metric:.6g}")
    print(f"patch artifacts under {out_dir}")
    return result


if __name__ == "__main__":
    main()
