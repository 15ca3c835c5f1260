"""WidowX / BridgeData V2 real-robot evaluation (API-shape parity).

Mirrors the reference's experiments/robot/bridge/ (widowx_env.py,
run_bridgev2_eval.py, bridgev2_utils.py): a gym-style wrapper around the
`widowx_envs` WidowX client, a rollout driver, and obs/save utilities. The
hardware stack (widowx_envs + ROS camera) is physical-robot-only; everything
here degrades to informative ImportErrors off-robot, while the policy side
(inference on the card, gripper conventions, image preprocessing) is the
same code the LIBERO path uses.

One difference from the JAX package's driver: the rollout records the
robot's `proprio` state, the key `WidowXGym.get_observation` returns. The
JAX driver reads `obs.get("state", ...)`, a key the observation never has,
so its saved states are all zeros.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..utils.gripper import invert_gripper_action, normalize_gripper_action
from .policy import VLAPolicy
from .processing import resize_bicubic_pil


@dataclass
class BridgeEvalConfig:
    """run_bridgev2_eval.py:37-81 flag surface."""

    host_ip: str = "localhost"
    port: int = 5556
    initial_eep: Tuple[float, float, float] = (0.3, 0.0, 0.15)
    blocking: bool = False
    max_episodes: int = 50
    max_steps: int = 60
    control_frequency: float = 5.0
    resize_size: int = 224
    unnorm_key: str = "bridge_orig"
    save_dir: str = "./bridge_rollouts"
    # Jacobi self-speculative decode: draft each control step with the
    # previous step's tokens (greedy, models/decode.py) — at 5 Hz the step
    # budget is 200 ms; a correct draft replaces the 6-step decode tail with
    # one verification pass
    jacobi: bool = False


class WidowXGym:
    """Gym-style wrapper over the WidowX client (widowx_env.py:17-60)."""

    def __init__(self, cfg: BridgeEvalConfig):
        try:
            from widowx_envs.widowx_env_service import WidowXClient, WidowXConfigs
        except ImportError as e:
            raise ImportError(
                "bridge evaluation requires `widowx_envs` (physical WidowX "
                "robot + ROS camera stack); see the reference README for setup"
            ) from e
        env_params = WidowXConfigs.DefaultEnvParams.copy()
        env_params["start_state"] = list(cfg.initial_eep) + [0, 0, 0, 1]
        self.client = WidowXClient(host=cfg.host_ip, port=cfg.port)
        self.client.init(env_params)
        self.cfg = cfg

    def reset(self) -> Dict:
        self.client.reset()
        return self.get_observation()

    def get_observation(self) -> Dict:
        obs = self.client.get_observation()
        img = obs["image"]
        if img.ndim == 1:  # flattened stream format
            side = int(np.sqrt(img.shape[0] / 3))
            img = img.reshape(3, side, side).transpose(1, 2, 0) * 255
            img = img.astype(np.uint8)
        return {"full_image": img, "proprio": obs.get("state")}

    def step(self, action: np.ndarray) -> Dict:
        self.client.step_action(action, blocking=self.cfg.blocking)
        return self.get_observation()


def get_next_task_label(task_label: str) -> str:
    """Between-episode task relabel prompt (bridgev2_utils.py:50-64): Enter
    keeps the current instruction, any other input replaces it."""
    if task_label == "":
        user_input = ""
        while user_input == "":
            user_input = input("Enter the task name: ").strip()
        task_label = user_input
    else:
        user_input = input(
            f"Enter the task name (or leave blank to repeat '{task_label}'): "
        ).strip()
        if user_input:
            task_label = user_input
    print(f"Task: {task_label}")
    return task_label


def save_rollout_video(frames, idx: int, save_dir: str, fps: int = 5) -> str:
    """MP4 replay of an episode (bridgev2_utils.py:67-76). Falls back to a
    stacked-frames .npy when no ffmpeg backend is installed."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"rollout-{idx + 1}.mp4")
    try:
        import imageio

        with imageio.get_writer(path, fps=fps) as writer:
            for img in frames:
                writer.append_data(np.asarray(img))
        return path
    except (ImportError, ValueError):
        path = os.path.join(save_dir, f"rollout-{idx + 1}.frames.npy")
        np.save(path, np.stack([np.asarray(f) for f in frames]))
        return path


def save_rollout_data(orig_images, images, states, actions, idx: int,
                      save_dir: str) -> str:
    """Full episode record — raw + preprocessed frames, proprio states,
    predicted actions — as one npz (bridgev2_utils.py:78-98)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"rollout-{idx + 1}.npz")
    np.savez(
        path,
        orig_images=np.asarray(orig_images),
        images=np.asarray(images),
        states=np.asarray(states),
        actions=np.asarray(actions),
    )
    return path


def run_bridge_eval(cfg: BridgeEvalConfig, policy: VLAPolicy, task_label: str):
    """Rollout driver (run_bridgev2_eval.py): human-in-the-loop episodes with
    per-episode task relabeling, MP4 replays, and full rollout npz records."""
    env = WidowXGym(cfg)
    os.makedirs(cfg.save_dir, exist_ok=True)
    dt = 1.0 / cfg.control_frequency
    for episode in range(cfg.max_episodes):
        task_label = get_next_task_label(task_label)
        obs = env.reset()
        orig_frames, frames, states, actions = [], [], [], []
        for t in range(cfg.max_steps):
            start = time.time()
            orig_frames.append(np.asarray(obs["full_image"]))
            frame = resize_bicubic_pil(obs["full_image"], cfg.resize_size)
            frames.append(frame)
            states.append(np.asarray(obs["proprio"]))
            action = policy.get_action(
                frame, task_label,
                **({"draft_tokens": "last"} if cfg.jacobi else {}),
            )
            action = invert_gripper_action(normalize_gripper_action(action, binarize=True))
            actions.append(np.asarray(action))
            obs = env.step(action)
            elapsed = time.time() - start
            if elapsed < dt:
                time.sleep(dt - elapsed)
        save_rollout_video(orig_frames, episode, cfg.save_dir)
        save_rollout_data(orig_frames, frames, states, actions, episode, cfg.save_dir)
        cont = input("episode done; continue? [y/n] ")
        if cont.strip().lower() != "y":
            break
