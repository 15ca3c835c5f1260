"""LIBERO dataset regeneration: replay HDF5 demos, filter no-op actions and
failed replays, re-render 256x256 frames -> `*_no_noops` datasets.

Equivalent of the reference's experiments/robot/libero/regenerate_libero_dataset.py,
ported from the JAX package's module unchanged (it holds no JAX code).
LIBERO + robosuite are required for the replay itself (gated); the no-op
filter `is_noop` is pure math and unit-tested without them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


def is_noop(action: np.ndarray, prev_action: Optional[np.ndarray] = None,
            threshold: float = 1e-4) -> bool:
    """A no-op action: near-zero L2 movement over all non-gripper dims AND the
    gripper action exactly equal to the previous timestep's
    (regenerate_libero_dataset.py:45-67)."""
    action = np.asarray(action, np.float64)
    if prev_action is None:
        return bool(np.linalg.norm(action[:-1]) < threshold)
    prev_action = np.asarray(prev_action, np.float64)
    return bool(
        np.linalg.norm(action[:-1]) < threshold and action[-1] == prev_action[-1]
    )


@dataclass
class RegenConfig:
    libero_task_suite: str = "libero_spatial"
    libero_raw_data_dir: str = ""
    libero_target_dir: str = ""
    image_size: int = 256


def regenerate_dataset(cfg: RegenConfig) -> None:
    try:
        import h5py
        from libero.libero import benchmark
        from .libero import get_libero_env
    except ImportError as e:
        raise ImportError(
            "dataset regeneration requires LIBERO + h5py + a sim stack"
        ) from e

    suite = benchmark.get_benchmark_dict()[cfg.libero_task_suite]()
    os.makedirs(cfg.libero_target_dir, exist_ok=True)
    for task_id in range(suite.n_tasks):
        task = suite.get_task(task_id)
        src = os.path.join(cfg.libero_raw_data_dir, f"{task.name}_demo.hdf5")
        dst = os.path.join(cfg.libero_target_dir, f"{task.name}_demo.hdf5")
        env, _ = get_libero_env(task, resolution=cfg.image_size)
        with h5py.File(src, "r") as fin, h5py.File(dst, "w") as fout:
            grp = fout.create_group("data")
            for demo_key in fin["data"]:
                actions = np.asarray(fin[f"data/{demo_key}/actions"])
                states = np.asarray(fin[f"data/{demo_key}/states"])
                env.reset()
                env.set_init_state(states[0])
                frames, kept_actions = [], []
                prev = None
                done = False
                for a in actions:
                    if is_noop(a, prev):
                        prev = a
                        continue
                    obs, _, done, _ = env.step(a.tolist())
                    frames.append(obs["agentview_image"][::-1, ::-1])
                    kept_actions.append(a)
                    prev = a
                if not done:
                    print(f"replay failed, dropping {demo_key}")
                    continue
                d = grp.create_group(demo_key)
                d.create_dataset("actions", data=np.asarray(kept_actions))
                d.create_dataset("obs/agentview_rgb", data=np.asarray(frames, np.uint8))
        env.close()
        print(f"regenerated {dst}")
