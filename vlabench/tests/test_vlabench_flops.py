"""The FLOP counts of common/flops.py against the matrix products the
program actually runs, counted by torch's FlopCounterMode, on small
configurations of both families (Phi-2's two-matrix MLP and single tower,
Mistral's grouped-query heads and two towers)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from roboticattack_torch.attacks import engine
from roboticattack_torch.models.vlm import init_vla_params

from vlabench.common import flops, inputs
from vlabench.common.program import vla_config
from vlabench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("make", [tiny.tiny_mistral, tiny.tiny_phi], ids=["mistral", "phi"])
def test_inner_step_flops_equal_the_products_counted(make):
    cfg = make()
    cfg["dtype"] = "float32"
    vcfg = dataclasses.replace(vla_config(cfg), remat=False)  # recomputation is not counted
    params = init_vla_params(torch.Generator().manual_seed(0), vcfg)
    size = cfg["vision"]["towers"][0]["image_size"]
    nb = next(inputs.batches(3, size, 2, 32))
    batch = engine.batch_to_device(engine.AttackBatch(*nb), "cpu")
    d = inputs.step_draws(3, 0, 1, 2, size, 50)[0]
    spec = engine.AttackSpec(objective="uada", inner_loop=1)
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    patch = inputs.initial_patch(3, 50)
    with FlopCounterMode(display=False) as counter:
        engine.patch_loss_and_grad(spec, vcfg, params, patch, batch, labels, engine.PatchDraws(*d))
    assert counter.get_total_flops() == flops.attack_inner_step(cfg, 2, 32)


def test_the_7b_counts():
    """72.1 and 58.3 TFLOP an inner step at bs 8, prompts of 32."""
    for name, want in (("vla-mistral-7b", 72.097084637184e12), ("phi-2-3b", 58.280573566976e12)):
        with open(os.path.join(HERE, "configs", name + ".json")) as f:
            cfg = json.load(f)
        assert flops.attack_inner_step(cfg, 8, 32) == pytest.approx(want, rel=1e-12)
    assert np.isclose(flops.PEAK_BF16_FLOPS, 989e12)
