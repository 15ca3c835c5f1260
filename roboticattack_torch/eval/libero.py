"""Closed-loop LIBERO evaluation with adversarial patches, in the port.

Capability-equivalent to the reference's
experiments/robot/libero/run_libero_eval_args_geo_batch.py: environment
rollouts on the host CPU, policy inference on the card, the patch pasted
onto every frame at a fixed position/geometry before the policy sees it. A
line-for-line port of the JAX package's `eval/libero.py`: the same protocol,
logs and lockstep schedule, with the port's policy and frame processing.

LIBERO/robosuite are optional heavy deps (absent on the dev box); everything
env-facing is reached through `get_libero_env` so the harness is importable
and unit-testable without them. Protocol constants preserved:
  - per-suite max_steps {spatial 193, object 254, goal 270, 10 505, 90 373}
    + 10 settle steps with the dummy action (:183-201);
  - clean-eval variant max_steps {220, 280, 300, 520, 400} (run_libero_eval.py);
  - gripper: [0,1] -> [-1,1], binarize, then sign-flip (:231-236);
  - success-rate txt logs + a `<suite>.txt` summary line with placement info
    (:296-298).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..attacks.artifacts import load_patch
from ..ops.patch_ops import simulation_paste_patch
from ..utils.gripper import invert_gripper_action, normalize_gripper_action
from .policy import VLAPolicy
from .processing import libero_frame

# run_libero_eval_args_geo_batch.py:183-192 (patched eval)
MAX_STEPS_PATCHED = {
    "libero_spatial": 193,
    "libero_object": 254,
    "libero_goal": 270,
    "libero_10": 505,
    "libero_90": 373,
}
# run_libero_eval.py:175-183 (clean eval)
MAX_STEPS_CLEAN = {
    "libero_spatial": 220,
    "libero_object": 280,
    "libero_goal": 300,
    "libero_10": 520,
    "libero_90": 400,
}
NUM_SETTLE_STEPS = 10
DUMMY_ACTION = [0, 0, 0, 0, 0, 0, -1]  # libero_utils.py:30


@dataclass
class LiberoEvalConfig:
    task_suite_name: str = "libero_spatial"
    num_trials_per_task: int = 50
    patchroot: Optional[str] = None       # None -> clean eval
    x: int = 0
    y: int = 0
    angle: float = 0.0
    shx: float = 0.0
    shy: float = 0.0
    geometry: bool = False
    center_crop: bool = False
    resize_size: int = 224
    seed: int = 7
    output_dir: str = "./experiments/logs"
    save_videos: bool = False
    unnorm_key: Optional[str] = None
    # >1 = lockstep-batched rollouts: run this many trials of a task as
    # simultaneous environments sharing ONE batched policy call per step,
    # which the reference's bs=1 `generate` path can't do: the 7B decode is
    # weight-streaming-bound, so N envs cost about one env's wall-clock.
    # Costs N live simulator instances of host RAM.
    batch_trials: int = 1
    # Jacobi self-speculative decode: draft each step with the previous
    # step's tokens (greedy, models/decode.py) — consecutive control steps
    # mostly repeat action tokens, so the 6-step decode tail usually
    # collapses to one verification pass
    jacobi: bool = False


def get_libero_env(task, resolution: int = 256):
    """BDDL task -> seeded OffScreenRenderEnv (libero_utils.py:18-27)."""
    from libero.libero import get_libero_path
    from libero.libero.envs import OffScreenRenderEnv

    task_bddl_file = os.path.join(
        get_libero_path("bddl_files"), task.problem_folder, task.bddl_file
    )
    env = OffScreenRenderEnv(
        bddl_file_name=task_bddl_file, camera_heights=resolution, camera_widths=resolution
    )
    env.seed(0)
    return env, task.language


def apply_patch_to_frame(frame_u8: np.ndarray, patch: Optional[np.ndarray],
                         cfg: LiberoEvalConfig) -> np.ndarray:
    if patch is None:
        return frame_u8
    return simulation_paste_patch(
        frame_u8, patch, position=(cfg.x, cfg.y),
        geometry=cfg.geometry or (cfg.angle or cfg.shx or cfg.shy),
        angle=cfg.angle, shx=cfg.shx, shy=cfg.shy,
    )


def eval_libero(cfg: LiberoEvalConfig, policy: VLAPolicy):
    """Run the full suite; returns (total_successes, total_episodes)."""
    try:
        from libero.libero import benchmark
    except ImportError as e:
        raise ImportError(
            "closed-loop evaluation requires the LIBERO benchmark "
            "(pip install libero + robosuite on a machine with a sim stack); "
            "the policy/decode path itself runs without it — see "
            "roboticattack_torch.eval.policy.VLAPolicy"
        ) from e

    patch = load_patch(cfg.patchroot) if cfg.patchroot else None
    max_steps = (MAX_STEPS_PATCHED if patch is not None else MAX_STEPS_CLEAN)[
        cfg.task_suite_name
    ]
    os.makedirs(cfg.output_dir, exist_ok=True)
    # byte-compatible with the reference's run_id scheme
    # (run_libero_eval_args_geo_batch.py:130-135 + the queue's run_id_note
    # `x_y_angle_shx_shy`, eval_queue_single_four_spec.py:36-39) so reference
    # tooling's skip-if-done resume sees our runs and vice versa
    # :g renders whole floats the way the queue's int dict does ("0", not
    # "0.0") — the reference queue passes run_id_note as a pre-built string of
    # ints, and resume interop needs the exact filename
    run_id_note = "_".join(format(v, "g") for v in
                           (cfg.x, cfg.y, cfg.angle, cfg.shx, cfg.shy))
    log_path = os.path.join(
        cfg.output_dir, f"EVAL-{cfg.task_suite_name}--{run_id_note}.txt"
    )
    log = open(log_path, "a")

    suite = benchmark.get_benchmark_dict()[cfg.task_suite_name]()
    total_episodes, total_successes = 0, 0
    for task_id in range(suite.n_tasks):
        task = suite.get_task(task_id)
        initial_states = suite.get_task_init_states(task_id)
        if cfg.batch_trials > 1:
            task_successes, eps = _run_task_batched(
                cfg, policy, task, initial_states, max_steps, patch, log,
                task_id, total_successes, total_episodes,
            )
            total_successes += task_successes
            total_episodes += eps
            print(f"[{cfg.task_suite_name}] task {task_id}: "
                  f"{task_successes}/{cfg.num_trials_per_task} (batched x{cfg.batch_trials})")
            continue
        env, task_description = get_libero_env(task)
        task_successes = 0
        for episode_idx in range(cfg.num_trials_per_task):
            env.reset()
            obs = env.set_init_state(initial_states[episode_idx % len(initial_states)])
            t, done = 0, False
            frames = []
            while t < max_steps + NUM_SETTLE_STEPS:
                try:
                    if t < NUM_SETTLE_STEPS:
                        obs, _, done, _ = env.step(DUMMY_ACTION)
                        t += 1
                        continue
                    frame = libero_frame(obs["agentview_image"], cfg.resize_size)
                    frame = apply_patch_to_frame(frame, patch, cfg)
                    if cfg.save_videos:
                        frames.append(frame)
                    # kwarg only in jacobi mode: duck-typed policies (mocks,
                    # recorders) need not know about drafts
                    action = policy.get_action(
                        frame, task_description,
                        **({"draft_tokens": "last"} if cfg.jacobi else {}),
                    )
                    action = normalize_gripper_action(action, binarize=True)
                    action = invert_gripper_action(action)
                    obs, _, done, _ = env.step(action.tolist())
                    if done:
                        break
                    t += 1
                except Exception as e:  # reference swallows per-step errors (:246-249)
                    print(f"episode error: {e}")
                    break
            total_episodes += 1
            task_successes += int(done)
            total_successes += int(done)
            if cfg.save_videos and frames:
                _write_video(frames, cfg.output_dir, task_description, episode_idx, done)
            log.write(
                f"task={task_id} ep={episode_idx} success={bool(done)} "
                f"running={total_successes}/{total_episodes}\n"
            )
            log.flush()
        print(f"[{cfg.task_suite_name}] task {task_id}: "
              f"{task_successes}/{cfg.num_trials_per_task}")
        env.close()

    # BYTE-exact reference summary line (run_libero_eval_args_geo_batch.py:297-298,
    # including the trailing space before the newline) — downstream scrapers of
    # the reference's <suite>.txt files parse ours unchanged
    summary = (
        f"success_rate/total:{float(total_successes) / float(max(total_episodes, 1))}, "
        f"num_episodes/total:{total_episodes} "
        f"position_info:{cfg.angle}_{cfg.shx}_{cfg.shy}_{cfg.x}_{cfg.y} \n"
    )
    with open(os.path.join(cfg.output_dir, f"{cfg.task_suite_name}.txt"), "a") as f:
        f.write(summary)
    log.close()
    print(summary)
    return total_successes, total_episodes


def _run_task_batched(cfg: LiberoEvalConfig, policy: VLAPolicy, task,
                      initial_states, max_steps: int, patch, log,
                      task_id: int, running_successes: int, running_episodes: int):
    """Lockstep-batched trials of one task: groups of `cfg.batch_trials`
    simultaneous environments share ONE batched policy call per control step.

    Protocol-equivalent to the sequential loop (settle steps, patch paste,
    gripper chain, per-episode log lines, success accounting); only the
    execution schedule differs. The last partial group is PADDED to the full
    lockstep width with repeated frames (discarded) so every decode keeps
    one batch width (a width change would also drop the Jacobi draft).
    Returns (task_successes, episodes)."""
    n, bs = cfg.num_trials_per_task, cfg.batch_trials
    if n <= 0:
        return 0, 0
    task_successes = 0
    # one env pool per task, reused (reset) across lockstep groups — real
    # robosuite env construction is expensive; this is bs instances of it
    pool = [get_libero_env(task) for _ in range(min(bs, n))]
    task_description = pool[0][1]
    for start in range(0, n, bs):
        idxs = list(range(start, min(start + bs, n)))
        envs, obs = [], []
        for j, i in enumerate(idxs):
            env = pool[j][0]
            env.reset()
            obs.append(env.set_init_state(initial_states[i % len(initial_states)]))
            envs.append(env)
        k = len(envs)
        succeeded = [False] * k
        finished = [False] * k
        frames_hist = [[] for _ in range(k)]
        for _ in range(NUM_SETTLE_STEPS):
            for j, env in enumerate(envs):
                try:
                    obs[j], _, _, _ = env.step(DUMMY_ACTION)
                except Exception as e:  # parity with the sequential try scope
                    print(f"episode error: {e}")
                    finished[j] = True

        t = 0
        last_frame = [None] * k
        while t < max_steps and not all(finished):
            frames = []
            for j in range(k):
                # finished envs only need to keep the stack's shape — reuse
                # their last frame instead of paying the flip/JPEG/resize cost
                if finished[j] and last_frame[j] is not None:
                    frames.append(last_frame[j])
                    continue
                try:
                    frame = libero_frame(obs[j]["agentview_image"], cfg.resize_size)
                    frame = apply_patch_to_frame(frame, patch, cfg)
                except Exception as e:  # one env's render error fails ONE episode
                    print(f"episode error: {e}")
                    finished[j] = True
                    frame = last_frame[j] if last_frame[j] is not None else np.zeros(
                        (cfg.resize_size, cfg.resize_size, 3), np.uint8
                    )
                last_frame[j] = frame
                frames.append(frame)
                if cfg.save_videos and not finished[j]:
                    frames_hist[j].append(frame)
            stack = np.stack(frames)
            if k < bs:  # keep the decode's batch width
                stack = np.concatenate([stack, np.repeat(stack[-1:], bs - k, axis=0)])
            try:
                actions = policy.get_action_batch(
                    stack, task_description,
                    **({"draft_tokens": "last"} if cfg.jacobi else {}),
                )[:k]
            except Exception as e:
                # a policy failure loses this GROUP (episodes fail), not the
                # whole suite — mirrors the sequential path's swallow scope
                print(f"episode error (batched policy call): {e}")
                for j in range(k):
                    finished[j] = True
                break
            for j, env in enumerate(envs):
                if finished[j]:
                    continue
                try:
                    action = normalize_gripper_action(actions[j], binarize=True)
                    action = invert_gripper_action(action)
                    obs[j], _, done, _ = env.step(action.tolist())
                    if done:
                        succeeded[j] = finished[j] = True
                except Exception as e:  # reference swallows per-step errors (:246-249)
                    print(f"episode error: {e}")
                    finished[j] = True
            t += 1

        for j, i in enumerate(idxs):
            task_successes += int(succeeded[j])
            running_successes += int(succeeded[j])
            running_episodes += 1
            if cfg.save_videos and frames_hist[j]:
                _write_video(frames_hist[j], cfg.output_dir, task_description, i,
                             succeeded[j])
            log.write(
                f"task={task_id} ep={i} success={succeeded[j]} "
                f"running={running_successes}/{running_episodes}\n"
            )
            log.flush()
    for env, _ in pool:
        env.close()
    return task_successes, n


def _write_video(frames, out_dir, task_description, episode_idx, success):
    try:
        import imageio
    except ImportError:
        return
    d = os.path.join(out_dir, "rollouts")
    os.makedirs(d, exist_ok=True)
    tag = task_description.replace(" ", "_")[:40]
    path = os.path.join(d, f"{tag}-ep{episode_idx}-{'ok' if success else 'fail'}.mp4")
    imageio.mimwrite(path, frames, fps=30)
