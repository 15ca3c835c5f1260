"""The comparison that decides `correct`: the program's readings against
the reference's, each a relative gap held to the cell's limit.

For a training-like step (the patch attack: the patch is the one parameter
leaf, AdamW its optimizer), after the first outer step of set-up:
- loss_gap: the largest over the inner steps of |loss - reference loss| /
  |reference loss|;
- m_norm_gap: |‖m‖ - ‖m_ref‖| / ‖m_ref‖ of AdamW's first moment, the
  gradients as the optimizer took them;
- delta_norm_gap: |‖Δ‖ - ‖Δ_ref‖| / ‖Δ_ref‖ of the patch's change over
  the step;
- m_diff: ‖m - m_ref‖ / ‖m_ref‖, and delta_diff: ‖Δ - Δ_ref‖ / ‖Δ_ref‖,
  which see an error across the vector as well as along it (a gap of norms
  sees the first only to second order).
A cell holds the readings its `limits` name.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0 else float("inf")


def norm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return rel_gap(float(got.double().norm()), float(want.double().norm()))


def diff(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm()) if want.norm() > 0 else float("inf")


def attack_readings(first: Dict, reference) -> Dict[str, float]:
    """The numbers of a run: `first` holds the program's losses, patch0,
    patch and m after the first outer step; `reference` the same from the
    reference (an AttackTrace)."""
    losses: List[float] = first["losses"]
    if len(losses) != len(reference.losses):
        return dict.fromkeys(("loss_gap", "m_norm_gap", "delta_norm_gap", "m_diff", "delta_diff"), float("inf"))
    p0 = first["patch0"].double()
    delta, delta_ref = first["patch"].double() - p0, reference.patch.cpu().double() - p0
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(losses, reference.losses)),
        "m_norm_gap": norm_gap(first["m"], reference.m.cpu()),
        "delta_norm_gap": norm_gap(delta, delta_ref),
        "m_diff": diff(first["m"], reference.m.cpu()),
        "delta_diff": diff(delta, delta_ref),
    }


def held(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each reading that `limits` names, beside its limit; a reading that is
    not finite is no reading (None), and fails."""
    return {k: {"value": readings[k] if math.isfinite(readings[k]) else None, "limit": float(v)}
            for k, v in limits.items()}


def holds(checks: Dict[str, Dict]) -> bool:
    """`correct`: every reading there and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def attack_checks(first: Dict, reference, limits: Dict[str, float]) -> Dict[str, Dict]:
    """The readings that the cell holds to a limit, each with its limit."""
    return held(attack_readings(first, reference), limits)
