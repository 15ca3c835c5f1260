#!/usr/bin/env python3
"""The 7B train step's learning rate, swept on one card.

    python scripts/sweep_train_lr.py [--lrs 5e-4,2e-4,1e-4,5e-5,2e-5]

For each rate, chip_smoke.py's `train` phase run on fresh seeded OpenVLA-7B
weights (bf16, flash, remat; the towers frozen; fsdp on one rank; one fixed
dummy batch of 8, prompts padded to 32): the loss at each of the phase's
steps and after the last update, and the share of the LLM's elements that
the second step (the first at lr > 0) changed. The weights are bf16 with no
f32 master copy (as in the JAX package), so an Adam step below half a bf16
ulp of a weight is lost; a step the size of most weights' ulp moves the
random model far enough that the loss on the batch rises. One line per
rate, then the card line.

Not part of the smoke run: it is how chip_smoke.TRAIN_LR was chosen. Needs
CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def sweep(lrs) -> list:
    cfg = c.get_config(c.MODEL)
    batch_np = next(c.dummy_batches(c.TRAIN_BS))
    params = c.init_vla_params(torch.Generator(device=c.DEVICE).manual_seed(c.SEED), cfg)
    host = {path: t.to("cpu", copy=True) for path, t in c.tree_leaves(params)}
    del params
    rows = []
    for lr in lrs:
        params = c.init_vla_params(torch.Generator(device=c.DEVICE).manual_seed(c.SEED), cfg)
        trainer = c.VLATrainer(params, cfg, c.train_config(learning_rate=lr), device=c.DEVICE)
        del params
        losses, share = [], None
        for i in range(c.TRAIN_STEPS):
            losses.append(trainer.run_training(iter([batch_np]), 1))
            if i == 1:
                n = total = 0
                for p, t in c.tree_leaves(trainer.params):
                    if p[0] == "llm":
                        n += int((t != host[p].to(t.device)).sum())
                        total += t.numel()
                share = n / total
        batch = trainer.place(batch_np)
        with torch.no_grad():
            pixels = c.dual_normalize(batch.images).to(torch.bfloat16)
            after = c.vla_forward(trainer.params, cfg, batch.input_ids, batch.attention_mask, pixels,
                                  batch.labels).loss.item()
        row = {"lr": lr, "losses": losses, "loss_after_last_update": after, "step2_changed_share": share}
        c.log(json.dumps(row))
        rows.append(row)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="5e-4,2e-4,1e-4,5e-5,2e-5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_train_lr: CUDA is not available", file=sys.stderr)
        return 1
    sweep([float(x) for x in args.lrs.split(",")])
    print(c.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
