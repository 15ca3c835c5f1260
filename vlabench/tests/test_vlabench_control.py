"""The correctness check fails what it has to fail, on small configurations
on the CPU:
- the control: the reference computed with float8 products put in the
  program's place, which separates from the program as on the card;
- a run whose timed path is broken underneath, driven through the harness
  with the look for a card skipped, against the cell's own limits: a step that returns its state
  unchanged, and a step that leaves half of the batch out and takes the
  mean over the rest. (One chip: no exchange between chips to leave out.)"""

import json
import os

import pytest
import torch

from roboticattack_torch.attacks import engine

from vlabench import calibrate, run
from vlabench.reference import compare
from vlabench.reference import vla as ref
from vlabench.tests import tiny

CELLS = [("attack-uada-mistral7b-bs8", tiny.tiny_mistral), ("attack-uada-phi2-bs8", tiny.tiny_phi)]


def passes(readings, limits):
    return all(readings[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell,make", CELLS, ids=["mistral", "phi"])
def test_the_control_separates_from_the_program(cell, make):
    """A small model accumulates less rounding than the cell's, so both
    sides read lower here than on the card; what carries over is the
    separation the limits were set from: the control's smallest reading at
    least 3x the program's largest, on the difference norms that the cell
    holds, and the program inside the cell's limits."""
    limits = run.cell_files(cell)[0]["limits"]
    rows = [calibrate.readings(cell, seed, True, "cpu", make()) for seed in (21, 22, 23)]
    for r in rows:
        assert passes(r["program"], limits), r
    for k in ("m_diff", "delta_diff"):
        assert k in limits
        assert min(r["control"][k] for r in rows) >= 3 * max(r["program"][k] for r in rows), (k, rows)


@pytest.mark.parametrize("cell", [c for c, _ in CELLS], ids=["mistral", "phi"])
def test_the_cards_readings_under_the_cell_limits(cell):
    """The readings `calibrate.py` took on the card at the cell's own size
    (`vlabench/calibration/<cell>.jsonl`: the program on 12 seeds, the
    float8 control and the half-batch fault on 3), put through the
    comparison that decides `correct` with the cell's limits: the program
    is correct on every seed, the control and the fault on none."""
    limits = run.cell_files(cell)[0]["limits"]
    path = os.path.join(run.HERE, "calibration", cell + ".jsonl")
    with open(path) as f:
        rows = [r for r in map(json.loads, f) if "seed" in r]
    assert len(rows) >= 12 and sum("control" in r for r in rows) >= 3
    for r in rows:
        got = calibrate.verdicts(r, limits)
        assert got["program"] is True, r
        assert got.get("control", False) is False and got.get("half_batch", False) is False, r


def unchanged(spec, state, grad, lr):
    return engine.AttackState(patch=state.patch, opt=state.opt, grad_acc=torch.zeros_like(grad)), grad


def half_batch(original):
    def broken(spec, cfg, params, patch, batch, labels, draws, mesh=None):
        n = batch.images.shape[0] // 2
        return original(spec, cfg, params, patch, engine.AttackBatch(*(t[:n] for t in batch)), labels[:n],
                        engine.PatchDraws(*(t[:n] for t in draws)), mesh)
    return broken


@pytest.mark.parametrize("cell,make", CELLS, ids=["mistral", "phi"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, make, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(engine, "update_patch", unchanged)
    else:
        monkeypatch.setattr(engine, "patch_loss_and_grad", half_batch(engine.patch_loss_and_grad))
    out = run.run_cell(cell, 2**31 + 11, 0.5, False, device="cpu", config_override=make())
    assert out["correct"] is False, out["checks"]
    assert out["metrics"]["attack_steps_per_s"]["value"] > 0


def test_readings_of_a_state_left_unchanged_are_one():
    p0 = torch.rand(4, 4, 3)
    first = {"losses": [1.0], "patch0": p0, "patch": p0.clone(), "m": torch.zeros(4, 4, 3)}
    got = compare.attack_readings(first, ref.AttackTrace([1.0], p0 + 0.1, torch.ones(4, 4, 3), None))
    assert got["loss_gap"] == 0.0 and got["m_norm_gap"] == got["delta_norm_gap"] == got["m_diff"] == 1.0
