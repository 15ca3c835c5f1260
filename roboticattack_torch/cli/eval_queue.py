"""Eval-queue CLI: batch closed-loop evaluation over the four LIBERO suites
(evaluation_tool/eval_queue_single_four_spec.py equivalent).

  python -m roboticattack_torch.cli.eval_queue --patch_root run/uada/<id> \
      --checkpoint /ckpts --output experiments/logs --num_trials 50
Expects <patch_root>/<suite>/patch.pt per suite, or a single --patch applied
to all suites. Each suite runs `python -m roboticattack_torch.cli.eval_libero`
in a subprocess; other flags (e.g. `--device cpu`, `--quantize int4`) pass
through to it.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--patch_root", default=None, type=str)
    p.add_argument("--patch", default=None, type=str, help="single patch for all suites")
    p.add_argument("--output", default="experiments/logs", type=str)
    p.add_argument("--checkpoint", default=None, type=str)
    p.add_argument("--num_trials", default=50, type=int)
    p.add_argument("--max_concurrent", default=1, type=int)
    # geometry must flow through run_queue (not extra args) so the eval's log
    # filename and the queue's resume marker stay the same file
    p.add_argument("--angle", default=0, type=int)
    p.add_argument("--shx", default=0, type=int)
    p.add_argument("--shy", default=0, type=int)
    args, extra = p.parse_known_args(argv)
    for banned in ("--angle", "--shx", "--shy"):
        # catch both '--angle 5' and '--angle=5' — either form in extra_args
        # would desync the eval's log filename from the queue's resume marker
        if any(e == banned or e.startswith(banned + "=") for e in extra):
            raise SystemExit(f"pass {banned} as a first-class flag, not an extra")

    from ..eval.queue import SUITE_PLACEMENTS, run_queue

    if args.patch:
        patches = {s: args.patch for s in SUITE_PLACEMENTS}
    elif args.patch_root:
        patches = {
            s: os.path.join(args.patch_root, s, "patch.pt") for s in SUITE_PLACEMENTS
        }
    else:
        raise SystemExit("pass --patch or --patch_root")
    results = run_queue(
        patches, args.output, checkpoint=args.checkpoint,
        num_trials=args.num_trials, max_concurrent=args.max_concurrent,
        extra_args=extra, angle=args.angle, shx=args.shx, shy=args.shy,
    )
    print("queue results:", results)


if __name__ == "__main__":
    main()
