"""Gripper sign/range conventions used by closed-loop evaluation.

Reference provenance: experiments/robot/robot_utils.py:75-102 and the LIBERO
eval loop (run_libero_eval_args_geo_batch.py:231-236): the policy emits a
gripper value in [0, 1]; evaluation rescales to [-1, +1], optionally snaps to
{-1, +1}, then flips the sign because LIBERO uses -1 = open, +1 = close.
"""

from __future__ import annotations

import numpy as np


def normalize_gripper_action(action: np.ndarray, binarize: bool = True) -> np.ndarray:
    """Map action[..., -1] from [0, 1] to [-1, +1]; optionally binarize by sign."""
    action = np.array(action, dtype=np.float64, copy=True)
    action[..., -1] = 2.0 * (action[..., -1] - 0.0) / (1.0 - 0.0) - 1.0
    if binarize:
        action[..., -1] = np.sign(action[..., -1])
    return action


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """Flip the gripper sign (policy: +1 = open; LIBERO env: -1 = open)."""
    action = np.array(action, dtype=np.float64, copy=True)
    action[..., -1] = -action[..., -1]
    return action
