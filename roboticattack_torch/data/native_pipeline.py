"""Native (C++) production file layer for the attack data pipeline (the JAX
package's `data/native_pipeline.py`: the same C++ reader, the same NumPy
standardization, the same reservoir shuffle, so one seed gives the same
frames in the same order in both packages).

Reads RLDS-format TFRecords directly through native/rlds_reader.cpp — TFRecord
framing, protobuf tf.Example parsing, repeated-bytes step access, and libjpeg
decode all happen in C++ with a prefetch ring — with the trajectory
standardization + BOUNDS_Q99 normalization replicated in NumPy. No TensorFlow
on the hot path.

Plugs into the existing pipeline as a frame source: `NativeFrameDataset`
exposes `.as_numpy_iterator()` yielding the same frame dicts
(image/action/language) that `trajectories_to_frames` produces, so
`frames_to_attack_batches` consumes either interchangeably. Select it with
`make_attack_iterators(..., file_layer='native')` via rlds.make_frame_dataset.

RLDS episode schema (TFDS-on-disk): one tf.Example per episode with flattened
step features — 'steps/observation/<image_key>' (repeated JPEG bytes, one per
step), 'steps/action' (float list, T*action_dim), and
'steps/language_instruction' (repeated bytes).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .rlds import SHUFFLE_BUFFER


# --- NumPy replicas of the tf standardization primitives ---------------------------
# (rlds.py:49-110; property-tested equal to the tf versions)

def np_binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Backward scan: in-between readings take the value of the next decisive
    state (utils/data_utils.py:106-134)."""
    out = np.empty_like(actions, dtype=np.float32)
    carry = np.float32(actions[-1])
    for i in range(len(actions) - 1, -1, -1):
        a = actions[i]
        if a > 0.95:
            carry = np.float32(1.0)
        elif a < 0.05:
            carry = np.float32(0.0)
        out[i] = carry
    return out


def np_invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - actions


def np_relabel_bridge_actions(state: np.ndarray, action: np.ndarray):
    """Movement dims := reached-state deltas; drop the final step
    (utils/data_utils.py:166-172). Returns (action[T-1, 7], keep_len T-1)."""
    movement = state[1:, :6] - state[:-1, :6]
    return np.concatenate([movement, action[:-1, -1:]], axis=1)


def np_bridge_orig_transform(traj: Dict) -> Dict:
    """bridge_orig standardization (oxe/transforms.py:61-86) in NumPy: drop the
    zero-action first step, binarize the gripper, state-delta relabel."""
    traj = {k: (v[1:] if not isinstance(v, dict) else {k2: v2[1:] for k2, v2 in v.items()})
            for k, v in traj.items()}
    action = np.concatenate(
        [traj["action"][:, :6], np_binarize_gripper_actions(traj["action"][:, -1])[:, None]],
        axis=1,
    ).astype(np.float32)
    state = traj["observation"]["state"]
    new_action = np_relabel_bridge_actions(state, action)
    return {
        "image": traj["image"][:-1],
        "action": new_action,
        "language": traj["language"][:-1],
        "observation": {"state": state[:-1]},
    }


def np_libero_transform(traj: Dict) -> Dict:
    """LIBERO *_no_noops standardization (oxe/transforms.py:827-841) in NumPy."""
    a = traj["action"]
    gripper = np_invert_gripper_actions(np.clip(a[:, -1:], 0.0, 1.0))
    traj["action"] = np.concatenate([a[:, :6], gripper], axis=1).astype(np.float32)
    return traj


NP_STANDARDIZATION_TRANSFORMS = {
    "bridge_orig": np_bridge_orig_transform,
    "libero_spatial_no_noops": np_libero_transform,
    "libero_object_no_noops": np_libero_transform,
    "libero_goal_no_noops": np_libero_transform,
    "libero_10_no_noops": np_libero_transform,
}


def np_normalize_actions(action: np.ndarray, stats: Dict) -> np.ndarray:
    """BOUNDS_Q99 + zero-out constant dims (utils/data_utils.py:76-101)."""
    a = stats["action"]
    low = np.asarray(a["q01"], np.float32)
    high = np.asarray(a["q99"], np.float32)
    mask = np.asarray(a.get("mask", [True] * len(a["q01"])), bool)
    normed = np.clip(2.0 * (action - low) / (high - low + 1e-8) - 1.0, -1.0, 1.0)
    out = np.where(mask, normed, action)
    zeros = np.asarray(a["min"]) == np.asarray(a["max"])
    return np.where(zeros, 0.0, out).astype(np.float32)


# (image resizing happens in C++: native_loader.decode_jpeg_resized fuses the
# libjpeg decode with a separable Lanczos-3 resample — the tf path's kernel
# family, obs_transforms.py:45-58 — in one native call)


# --- episode reading -----------------------------------------------------------------

def _episode_to_traj(ex, image_key: str) -> Optional[Dict]:
    """One parsed tf.Example (RLDS episode) -> trajectory dict of NumPy
    arrays; images stay encoded (decoded per-frame after subsampling)."""
    img_feature = f"steps/observation/{image_key}"
    try:
        t = ex.feature_count(img_feature)
    except KeyError:
        return None
    action = ex.feature("steps/action")
    if not isinstance(action, np.ndarray):
        return None
    action = action.reshape(t, -1).astype(np.float32)
    try:
        lang = [ex.bytes_at("steps/language_instruction", i) for i in range(t)]
    except KeyError:
        lang = [b""] * t
    traj: Dict = {
        "image": np.asarray([ex.bytes_at(img_feature, i) for i in range(t)], object),
        "action": action,
        "language": np.asarray(lang, object),
    }
    try:
        state = ex.feature("steps/observation/state")
        if isinstance(state, np.ndarray):
            traj["observation"] = {"state": state.reshape(t, -1).astype(np.float32)}
    except KeyError:
        traj["observation"] = {}
    return traj


def _version_sort_key(path: str):
    """Numeric-aware TFDS version ordering: '1.10.0' > '1.2.0' (lexicographic
    would invert them); non-numeric dirs sort below numeric ones."""
    parts = os.path.basename(path).split(".")
    try:
        return (1, tuple(int(p) for p in parts))
    except ValueError:
        return (0, tuple((0,) for _ in parts))


def discover_tfrecords(name: str, data_dir: str, split: str = "train") -> List[str]:
    """TFDS on-disk layout: <data_dir>/<name>/<version>/<name>-<split>.tfrecord-XXXXX-of-YYYYY.

    With several version dirs on disk, shards come from exactly ONE —
    the highest version that has shards for this split — so the shard list
    always aligns with that directory's dataset_info.json (a cross-version
    mix would silently misalign shardLengths and split boundaries)."""
    version_dirs = sorted(
        (d for d in glob.glob(os.path.join(data_dir, name, "*")) if os.path.isdir(d)),
        key=_version_sort_key,
        reverse=True,
    )
    for vdir in version_dirs:
        paths = sorted(glob.glob(os.path.join(vdir, f"*-{split}.tfrecord-*")))
        if paths:
            return paths
    raise FileNotFoundError(
        f"no TFRecords for split '{split}' under "
        f"{os.path.join(data_dir, name)} (version dirs: "
        f"{[os.path.basename(d) for d in version_dirs] or 'none'})"
    )


class NativeFrameDataset:
    """Infinite shuffled frame stream over RLDS TFRecords via the C++ reader.

    Drop-in for the tf.data frame pipeline: `.as_numpy_iterator()` yields
    {image uint8 [S,S,3] scaled later, action [7], language bytes} dicts.
    Shuffling uses a reservoir buffer like tf.data's shuffle()."""

    def __init__(
        self,
        paths: Sequence[str],
        name: str,
        stats: Dict,
        image_key: str = "image",
        image_size: int = 224,
        shuffle_buffer: int = SHUFFLE_BUFFER,
        seed: int = 42,
        train: bool = True,
        prefetch_depth: int = 8,
        records: Tuple[Optional[int], int, Optional[Tuple[int, int]]] = (None, 0, None),
        num_shards: int = 1,
        shard_index: int = 0,
        repeat: Optional[bool] = None,
    ) -> None:
        self.paths = list(paths)
        # epochs without end (default: in training), else one pass
        self.repeat = train if repeat is None else repeat
        # (skip, take, modulus) of data/rlds.py SplitPlan over the records of
        # `paths`, then every num_shards-th selected record from shard_index
        self.skip, self.take, self.modulus = records
        self.num_shards, self.shard_index = num_shards, shard_index
        self.name = name
        self.stats = stats
        self.image_key = image_key
        self.image_size = image_size
        self.shuffle_buffer = shuffle_buffer if train else 1
        self.seed = seed
        self.train = train
        self.prefetch_depth = prefetch_depth

    def _frames(self) -> Iterator[Dict]:
        from concurrent.futures import ThreadPoolExecutor

        from .native_loader import NativeRLDSReader, decode_jpeg_resized

        transform = NP_STANDARDIZATION_TRANSFORMS.get(self.name)
        # the C++ decode+resize releases the GIL for the whole ctypes call,
        # so an episode's frames decode in parallel on multi-core hosts;
        # order preserved by map(). On 1-2 core hosts a pool only adds
        # overhead, so decode serially there.
        cores = os.cpu_count() or 1
        workers = min(8, cores // 2) if cores > 2 else 0
        epoch = 0
        with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
            while True:
                reader = NativeRLDSReader(self.paths, prefetch_depth=self.prefetch_depth)
                got_any = False
                selected = 0
                for i, ex in enumerate(reader):
                    if self.skip is not None and i >= self.skip + self.take:
                        ex.close()
                        break
                    if not self._selects(i):
                        ex.close()
                        continue
                    selected += 1
                    if (selected - 1) % self.num_shards != self.shard_index:
                        ex.close()
                        continue
                    traj = _episode_to_traj(ex, self.image_key)
                    ex.close()
                    if traj is None:
                        continue
                    got_any = True
                    if transform is not None:
                        traj = transform(traj)
                    action = np_normalize_actions(traj["action"], self.stats)
                    decode = lambda b: decode_jpeg_resized(b, self.image_size)
                    frames_in = traj["image"][: action.shape[0]]
                    images = pool.map(decode, frames_in) if workers else map(decode, frames_in)
                    for i, image in enumerate(images):
                        yield {
                            "image": image,
                            "action": action[i],
                            "language": traj["language"][i],
                        }
                reader.close()
                if not got_any:
                    raise RuntimeError(f"no decodable RLDS episodes in {self.paths}")
                if not self.repeat:
                    return
                epoch += 1

    def _selects(self, i: int) -> bool:
        """Whether the split holds record i of `paths`."""
        if self.skip is not None:
            return self.skip <= i < self.skip + self.take
        if self.modulus is not None:
            return self.modulus[0] <= i % 100 < self.modulus[1]
        return True

    def as_numpy_iterator(self) -> Iterator[Dict]:
        rng = random.Random(self.seed)
        buf: List[Dict] = []
        for frame in self._frames():
            if self.shuffle_buffer <= 1:
                yield frame
                continue
            buf.append(frame)
            if len(buf) >= self.shuffle_buffer:
                idx = rng.randrange(len(buf))
                out = buf[idx]
                buf[idx] = buf[-1]
                buf.pop()
                yield out
        rng.shuffle(buf)
        yield from buf
