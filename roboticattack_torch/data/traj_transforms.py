"""Trajectory-level transforms beyond the attack path's W=1 flattening:
goal relabeling, task augmentation, subsampling, pad-mask bookkeeping.

Behavioral ports of the reference's prismatic/vla/datasets/rlds/utils/
goal_relabeling.py:15-32, task_augmentation.py:14-57, and
traj_transforms.py:74-104. The reference configures these but the attack
pipeline never consumes goals; they ship here for full pipeline parity
(e.g. goal-conditioned finetuning data).
"""

from __future__ import annotations

from typing import Dict

from .rlds import _tf


def tree_merge(*trees: Dict) -> Dict:
    """Recursive dict merge, later trees win (utils/data_utils.py:28-36)."""
    merged: Dict = {}
    for tree in trees:
        for key, value in tree.items():
            if isinstance(value, dict):
                merged[key] = tree_merge(merged.get(key, {}), value)
            else:
                merged[key] = value
    return merged


def to_padding(tensor):
    """Padding stand-in: zeros for numeric tensors, '' for strings
    (utils/data_utils.py:39-45)."""
    tf = _tf()
    if tensor.dtype == tf.string:
        return tf.fill(tf.shape(tensor), "")
    return tf.zeros_like(tensor)


def uniform_goal_relabel(traj: Dict) -> Dict:
    """Relabel each step's task with a uniformly-sampled FUTURE observation
    (goal_relabeling.py:15-32): goal index for step i ~ U[i+1, T)."""
    tf = _tf()
    traj_len = tf.shape(tf.nest.flatten(traj["observation"])[0])[0]
    rand = tf.random.uniform([traj_len])
    low = tf.cast(tf.range(traj_len) + 1, tf.float32)
    high = tf.cast(traj_len, tf.float32)
    goal_idxs = tf.minimum(tf.cast(rand * (high - low) + low, tf.int32), traj_len - 1)
    goal = tf.nest.map_structure(lambda x: tf.gather(x, goal_idxs), traj["observation"])
    traj["task"] = tree_merge(traj.get("task", {}), goal)
    return traj


def delete_task_conditioning(traj: Dict, keep_image_prob: float) -> Dict:
    """Per-step, keep EITHER the goal images (prob keep_image_prob) or the
    language instruction — never both (task_augmentation.py:14-57). No-op
    unless the task dict carries both modalities."""
    tf = _tf()
    task = traj.get("task", {})
    if "language_instruction" not in task:
        return traj
    image_keys = {k for k in task if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj

    traj_len = tf.shape(traj["action"])[0]
    keep_images = tf.random.uniform([traj_len]) < keep_image_prob
    # steps with a padded (empty) instruction must keep their images
    keep_images |= ~task["pad_mask_dict"]["language_instruction"]

    for key in image_keys | {"language_instruction"}:
        keep = keep_images if key in image_keys else ~keep_images
        task[key] = tf.where(keep, task[key], to_padding(task[key]))
        task["pad_mask_dict"][key] = tf.where(
            keep, task["pad_mask_dict"][key], tf.zeros_like(task["pad_mask_dict"][key])
        )

    # with goal images dropped, the goal timestep collapses to the final step
    task["timestep"] = tf.where(keep_images, task["timestep"], traj_len - 1)
    return traj


def subsample(traj: Dict, subsample_length: int) -> Dict:
    """Random subsample to at most `subsample_length` steps
    (traj_transforms.py:74-80)."""
    tf = _tf()
    traj_len = tf.shape(traj["action"])[0]

    def pick():
        indices = tf.random.shuffle(tf.range(traj_len))[:subsample_length]
        return tf.nest.map_structure(lambda x: tf.gather(x, indices), traj)

    # tf.cond keeps this graph-safe inside tf.data maps (the reference's
    # python `if` works there only because traj_len is static per call)
    return tf.cond(traj_len > subsample_length, pick, lambda: traj)


def add_pad_mask_dict(traj: Dict) -> Dict:
    """observation/task pad masks: string entries are padding iff empty,
    everything else is never padding (traj_transforms.py:84-104)."""
    tf = _tf()
    traj_len = tf.shape(traj["action"])[0]
    for group in ("observation", "task"):
        if group not in traj:
            continue
        masks = {}
        for key, value in traj[group].items():
            if isinstance(value, dict):
                continue
            if value.dtype == tf.string:
                masks[key] = tf.strings.length(value) != 0
            else:
                masks[key] = tf.ones([traj_len], dtype=tf.bool)
        traj[group]["pad_mask_dict"] = masks
    return traj
