"""RLDS data pipeline of the port: TFDS trajectories -> attack-ready frame
batches (the JAX package's `data/rlds.py`, with the same tf ops in the same
order, so one seed gives bit-equal frames in both packages).

Host-side tf.data, hidden from every GPU (`_tf`), as the reference runs it
(rlds/dataset.py:35). A dependency-light rebuild of
`prismatic/vla/datasets/rlds/`: the dlimp layer is replaced by plain tf.data
ops; behavior contracts preserved:

  - standardization: `bridge_orig` (drop first all-zero step, binarize gripper
    by backward scan, state-delta relabel; oxe/transforms.py:61-86) and the 4
    LIBERO `_no_noops` suites (clip+invert gripper; :827-842);
  - statistics: q01/q99/mean/std/min/max over all transformed actions, cached
    as JSON next to the data (utils/data_utils.py:185-271);
  - normalization: BOUNDS_Q99 with mask [True]*6+[False] and the min==max ->
    0 rule (utils/data_utils.py:76-101, oxe/materialize.py:37-42);
  - frames: JPEG decode + lanczos3 resize to 224 (obs_transforms.py:45),
    window chunking degenerate at W=1, shuffle 100k, train[:95%]/train[95%:]
    split (dataset.py:234-237).

TensorFlow is imported lazily, only by the functions that run tf ops; TFDS
itself is optional (`file_layer='tf'` needs it). The `tfrecord` and `native`
layers read the TFDS on-disk layout without it, and the pipeline is also
constructible from an in-memory trajectory dataset.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.prompting import TextTokenizer, build_vla_example, tokenizer_from_checkpoint
from .collator import collate

ACTION_NORM_MASK = [True] * 6 + [False]  # standard 7-dim EEF mask (materialize.py:40)
SHUFFLE_BUFFER = 100_000  # openvla_dataloader.py:101


def _tf():
    """TensorFlow with every GPU hidden from it, before any tf op runs: the
    card belongs to torch, and a GPU build of TF would map it and reserve
    its memory."""
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    return tf


# --- gripper relabeling primitives (tf graph ops) ------------------------------

def binarize_gripper_actions(actions):
    """Continuous [0,1] gripper -> binary, relabeling transition values by the
    state reached after them (backward scan; utils/data_utils.py:106-134)."""
    tf = _tf()
    open_mask, closed_mask = actions > 0.95, actions < 0.05
    in_between = tf.logical_not(tf.logical_or(open_mask, closed_mask))
    is_open_float = tf.cast(open_mask, tf.float32)

    def scan_fn(carry, i):
        return tf.cond(in_between[i], lambda: tf.cast(carry, tf.float32), lambda: is_open_float[i])

    return tf.scan(scan_fn, tf.range(tf.shape(actions)[0]), actions[-1], reverse=True)


def invert_gripper_actions(actions):
    return 1 - actions


def rel2abs_gripper_actions(actions):
    """Relative open/close commands -> absolute [0,1] state
    (utils/data_utils.py:141-162)."""
    tf = _tf()
    opening_mask, closing_mask = actions < -0.1, actions > 0.1
    thresholded = tf.where(opening_mask, 1, tf.where(closing_mask, -1, 0))

    def scan_fn(carry, i):
        return tf.cond(thresholded[i] == 0, lambda: carry, lambda: thresholded[i])

    start = -1 * thresholded[tf.argmax(thresholded != 0, axis=0)]
    start = tf.cond(start == 0, lambda: 1, lambda: start)
    new_actions = tf.scan(scan_fn, tf.range(tf.shape(actions)[0]), start)
    return tf.cast(new_actions, tf.float32) / 2 + 0.5


def relabel_bridge_actions(traj: Dict) -> Dict:
    """Movement actions := reached-state deltas; drop last step
    (utils/data_utils.py:166-172)."""
    tf = _tf()
    movement = traj["observation"]["state"][1:, :6] - traj["observation"]["state"][:-1, :6]
    truncated = tf.nest.map_structure(lambda x: x[:-1], traj)
    truncated["action"] = tf.concat([movement, traj["action"][:-1, -1:]], axis=1)
    return truncated


# --- dataset standardization (oxe/transforms.py behavior) ----------------------

def bridge_orig_transform(traj: Dict) -> Dict:
    tf = _tf()
    traj = tf.nest.map_structure(lambda x: x[1:], traj)  # first step has zero action
    traj["action"] = tf.concat(
        [traj["action"][:, :6], binarize_gripper_actions(traj["action"][:, -1])[:, None]],
        axis=1,
    )
    return relabel_bridge_actions(traj)


def libero_transform(traj: Dict) -> Dict:
    tf = _tf()
    gripper = invert_gripper_actions(tf.clip_by_value(traj["action"][:, -1:], 0, 1))
    traj["action"] = tf.concat([traj["action"][:, :6], gripper], axis=1)
    return traj


STANDARDIZATION_TRANSFORMS: Dict[str, Callable] = {
    "bridge_orig": bridge_orig_transform,
    "libero_spatial_no_noops": libero_transform,
    "libero_object_no_noops": libero_transform,
    "libero_goal_no_noops": libero_transform,
    "libero_10_no_noops": libero_transform,
}

# Datasets whose transform operates on the RESTRUCTURED {image, action,
# observation.state, language} layout (the attack datasets above; the OXE
# registry re-registers the same functions for them). Every other OXE
# transform expects the RAW TFDS schema and goes through
# load_tfrecord_oxe_trajectories on the tfrecord layer.
RESTRUCTURED_SCHEMA_DATASETS = frozenset(STANDARDIZATION_TRANSFORMS)

# dataset name -> (tfds image key, language key)
DATASET_IMAGE_KEYS: Dict[str, str] = {
    "bridge_orig": "image_0",
    "libero_spatial_no_noops": "image",
    "libero_object_no_noops": "image",
    "libero_goal_no_noops": "image",
    "libero_10_no_noops": "image",
}


def dataset_image_key(name: str) -> str:
    """Primary-camera observation key for a dataset: the attack datasets'
    table above, then the OXE registry's per-dataset `image_obs_keys.primary`
    (configs.py:54-673). Raw-schema OXE datasets are fully supported on the
    `tfrecord` file layer (load_tfrecord_oxe_trajectories); the `tf`/`native`
    layers cover the restructured-schema attack datasets."""
    if name in DATASET_IMAGE_KEYS:
        return DATASET_IMAGE_KEYS[name]
    from .oxe_registry import OXE_DATASET_CONFIGS  # lazy: oxe imports rlds

    cfg = OXE_DATASET_CONFIGS.get(name)
    if cfg is not None and cfg.image_obs_keys.get("primary"):
        return cfg.image_obs_keys["primary"]
    return "image"


# --- statistics ------------------------------------------------------------------

# the port's own cache directory: a cache the JAX package wrote never answers
# for the port
LOCAL_STATS_CACHE = os.path.expanduser(os.path.join("~", ".cache", "roboticattack_torch"))


def _moment_block(values: np.ndarray) -> Dict:
    return {
        "mean": values.mean(0).tolist(),
        "std": values.std(0).tolist(),
        "max": values.max(0).tolist(),
        "min": values.min(0).tolist(),
        "q01": np.quantile(values, 0.01, axis=0).tolist(),
        "q99": np.quantile(values, 0.99, axis=0).tolist(),
    }


def statistics_cache_path(hash_dependencies: Sequence[str],
                          save_path: Optional[str] = None) -> str:
    """Cache filename keyed by SHA-256 over the dependency strings —
    builder info + obs keys + the standardization transform's SOURCE — so
    editing a transform invalidates cached statistics
    (utils/data_utils.py:195-202)."""
    digest = hashlib.sha256("".join(hash_dependencies).encode("utf-8")).hexdigest()
    base = save_path if save_path else LOCAL_STATS_CACHE
    return os.path.join(base, f"dataset_statistics_{digest}.json")


def compute_dataset_statistics(traj_dataset, save_path: Optional[str] = None,
                               hash_dependencies: Sequence[str] = ()) -> Dict:
    """Aggregate action/proprio statistics over transformed trajectories;
    cache JSON in the reference's schema (action + proprio moment blocks +
    transition/trajectory counts, utils/data_utils.py:185-271). The proprio
    block falls back to zeros-like-action when the dataset carries no proprio,
    exactly like the reference's traj_map default (:221-225)."""
    cache_file = None
    if hash_dependencies:
        cache_file = statistics_cache_path(hash_dependencies, save_path)
        local_file = statistics_cache_path(hash_dependencies, None)
        for candidate in (cache_file, local_file):
            if os.path.exists(candidate):
                with open(candidate) as f:
                    return json.load(f)
    actions: List[np.ndarray] = []
    proprios: List[np.ndarray] = []
    num_transitions = 0
    num_trajectories = 0
    for traj in traj_dataset.as_numpy_iterator():
        act = np.asarray(traj["action"], np.float64)
        actions.append(act)
        obs = traj.get("observation") or {}
        proprio = obs.get("proprio") if isinstance(obs, dict) else None
        proprios.append(np.asarray(proprio, np.float64) if proprio is not None
                        else np.zeros_like(act))
        num_transitions += act.shape[0]
        num_trajectories += 1
    cat = np.concatenate(actions, axis=0)
    stats = {
        # normalize every dim but the absolute gripper (last) — [True]*6 +
        # [False] at the standard 7-dim width, [True]*9+[False] for EEF_R6's
        # 10 dims (oxe/materialize.py:37-42)
        "action": dict(
            _moment_block(cat), mask=[True] * (cat.shape[1] - 1) + [False]
        ),
        "proprio": _moment_block(np.concatenate(proprios, axis=0)),
        "num_transitions": num_transitions,
        "num_trajectories": num_trajectories,
    }
    if cache_file is not None:
        try:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            with open(cache_file, "w") as f:
                json.dump(stats, f)
        except OSError:
            os.makedirs(os.path.dirname(local_file), exist_ok=True)
            with open(local_file, "w") as f:
                json.dump(stats, f)
    return stats


def save_reference_statistics(stats_by_dataset: Dict[str, Dict], path: str) -> None:
    """Write the eval-side `dataset_statistics.json` (dataset name ->
    statistics blocks), the schema `predict_action` unnormalization consumes
    (experiments/robot/openvla_utils.py:60-70)."""
    with open(path, "w") as f:
        json.dump(stats_by_dataset, f, indent=2)


def normalize_traj_actions(traj: Dict, stats: Dict) -> Dict:
    """BOUNDS_Q99 + zero-out dims with min == max (utils/data_utils.py:76-101)."""
    tf = _tf()
    a = stats["action"]
    low = tf.constant(a["q01"], tf.float32)
    high = tf.constant(a["q99"], tf.float32)
    mask = tf.constant(a.get("mask", [True] * len(a["q01"])), tf.bool)
    x = traj["action"]
    normed = tf.clip_by_value(2.0 * (x - low) / (high - low + 1e-8) - 1.0, -1.0, 1.0)
    x = tf.where(mask, normed, x)
    zeros = tf.constant(np.array(a["min"]) == np.array(a["max"]), tf.bool)
    traj["action"] = tf.where(zeros, tf.zeros_like(x), x)
    return traj


# --- frame pipeline ---------------------------------------------------------------

def decode_and_resize(image, size: int = 224):
    """JPEG bytes or uint8 array -> uint8 [size, size, 3] via lanczos3
    (obs_transforms.py:45-58)."""
    tf = _tf()
    if image.dtype == tf.string:
        image = tf.io.decode_image(image, expand_animations=False, dtype=tf.uint8)
    image = tf.image.resize(image, (size, size), method="lanczos3", antialias=True)
    return tf.cast(tf.clip_by_value(tf.round(image), 0, 255), tf.uint8)


def trajectories_to_frames(traj_dataset, image_size: int = 224,
                           train: bool = True, shuffle_buffer: int = SHUFFLE_BUFFER,
                           seed: int = 42):
    """Standardized+normalized trajectories -> infinite shuffled frame stream
    of {image uint8, action f32[7], language string} (window W=1)."""
    tf = _tf()

    def to_frames(traj):
        return tf.data.Dataset.from_tensor_slices(
            {
                "image": traj["image"],
                "action": tf.cast(traj["action"], tf.float32),
                "language": traj["language"],
            }
        )

    ds = traj_dataset.flat_map(to_frames)
    ds = ds.map(
        lambda f: dict(f, image=decode_and_resize(f["image"], image_size)),
        num_parallel_calls=tf.data.AUTOTUNE,
    )
    ds = ds.repeat()
    if train:
        ds = ds.shuffle(shuffle_buffer, seed=seed)
    return ds.prefetch(tf.data.AUTOTUNE)


def load_tfds_trajectories(name: str, data_dir: Optional[str], split: str,
                           return_builder_info: bool = False):
    """TFDS loader with the reference's field extraction. Requires
    `tensorflow_datasets` (an optional dependency — gated).

    `return_builder_info=True` additionally returns `str(builder.info)` for
    the statistics-cache hash (dataset.py:215-218)."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(
            "tensorflow_datasets is required for real RLDS data; use "
            "--dataset dummy or provide a trajectory generator. "
            f"(requested dataset: {name})"
        ) from e
    tf = _tf()
    builder = tfds.builder(name, data_dir=data_dir)
    ds = builder.as_dataset(split=split, decoders={"steps": tfds.decode.SkipDecoding()})
    image_key = dataset_image_key(name)

    def restructure(episode):
        steps = episode["steps"]
        return {
            "image": steps["observation"][image_key],
            "action": tf.cast(steps["action"], tf.float32),
            "observation": {"state": steps["observation"].get("state")},
            "language": steps["language_instruction"]
            if "language_instruction" in steps
            else steps["observation"]["natural_language_instruction"],
        }

    mapped = ds.map(restructure, num_parallel_calls=tf.data.AUTOTUNE)
    if return_builder_info:
        return mapped, str(builder.info)
    return mapped


def _parse_split(split: str) -> Tuple[str, Optional[float], Optional[float]]:
    """'train' / 'train[:95%]' / 'train[95%:]' -> (base, lo_frac, hi_frac).

    Only PERCENT slices are supported; absolute-index specs like
    'train[:1000]' are rejected (not silently reinterpreted as percentages)."""
    m = re.fullmatch(r"(\w+)(?:\[(?:(\d+)%)?:(?:(\d+)%)?\])?", split)
    if m is None:
        raise ValueError(
            f"unsupported split spec '{split}' (only 'name' and percent "
            f"slices 'name[lo%:hi%]' are supported here)"
        )
    base, lo, hi = m.group(1), m.group(2), m.group(3)
    if "[" not in split:
        return base, None, None
    lo_f = int(lo) / 100 if lo else 0.0
    hi_f = int(hi) / 100 if hi else 1.0
    if not (0.0 <= lo_f <= 1.0 and 0.0 <= hi_f <= 1.0):
        raise ValueError(f"percent slice out of range in '{split}'")
    return base, lo_f, hi_f


def _tfrecord_records(name: str, data_dir: Optional[str], split: str):
    """Shared TFDS-on-disk record machinery: shard discovery, exact percent
    splits, and schema introspection. Returns
    (records tf.data.Dataset of serialized Examples, builder_info str,
    feature_map of the first record).

    Split percent boundaries ('train[:95%]' / 'train[95%:]',
    dataset.py:234-237) are exact when dataset_info.json carries the split's
    shardLengths (TFDS always writes them); without the file we fall back to
    a deterministic episode-index modulus (i % 100 < pct), which keeps
    train/val disjoint but interleaves rather than suffixes the val slice."""
    tf = _tf()
    from .native_pipeline import discover_tfrecords

    base_split, lo, hi = _parse_split(split)
    paths = discover_tfrecords(name, data_dir or ".", split=base_split)

    # --- bounds + builder info from dataset_info.json --------------------------
    info_path = os.path.join(os.path.dirname(paths[0]), "dataset_info.json")
    builder_info, total, shard_lengths = f"name={name}", None, None
    if os.path.exists(info_path):
        with open(info_path) as f:
            builder_info = f.read()
        try:
            splits = json.loads(builder_info).get("splits", [])
            lengths = next(
                (s.get("shardLengths", []) for s in splits if s.get("name") == base_split),
                [],
            )
            total = sum(int(n) for n in lengths) or None
            if len(lengths) == len(paths):  # per-shard counts align with files
                shard_lengths = [int(n) for n in lengths]
        except (ValueError, AttributeError):
            total = None

    # schema introspection: TFDS may legitimately write empty leading shards
    # (shardLengths allows 0), so walk shards until a record exists instead of
    # surfacing an opaque StopIteration from the first shard
    first = None
    for p in paths:
        for rec in tf.data.TFRecordDataset(p).take(1):
            first = rec.numpy()
            break
        if first is not None:
            break
    if first is None:
        raise ValueError(
            f"split '{split}' of '{name}' contains no records across "
            f"{len(paths)} shard(s) (first: {paths[0]})"
        )
    feature_map = tf.train.Example.FromString(first).features.feature

    split_paths, skip_start, take = paths, None, 0
    if lo is not None and total is not None:
        # exact TFDS percent-split boundaries
        start, stop = round(lo * total), round(hi * total)
        take = max(stop - start, 0)
        if shard_lengths is not None:
            # open only the shards overlapping [start, stop): a repeating val
            # iterator ('train[95%:]') must not re-read and discard 95% of
            # the dataset's bytes every epoch
            split_paths, cum = [], 0
            for path, n in zip(paths, shard_lengths):
                if cum + n > start and cum < stop:
                    if not split_paths:
                        skip_start = start - cum
                    split_paths.append(path)
                cum += n
            skip_start = skip_start or 0
        else:
            skip_start = start
        if not split_paths:
            split_paths, take = paths[:1], 0  # empty split: valid empty pipeline
    ds = tf.data.TFRecordDataset(split_paths)  # sorted shards = TFDS storage order
    if skip_start is not None:
        ds = ds.skip(skip_start).take(take)
    elif lo is not None:  # no dataset_info.json: deterministic index-modulus split
        lo_i, hi_i = round(lo * 100), round(hi * 100)
        ds = (
            ds.enumerate()
            .filter(lambda i, _: (i % 100 >= lo_i) & (i % 100 < hi_i))
            .map(lambda _, rec: rec)
        )
    return ds, builder_info, feature_map


def _image_feature(name: str, feature_map) -> Tuple[str, str]:
    """(image_key, 'steps/observation/<key>') with a clear error when the
    episode schema lacks the dataset's primary camera."""
    image_key = dataset_image_key(name)
    img_feature = f"steps/observation/{image_key}"
    if img_feature not in feature_map:
        raise KeyError(f"{img_feature} not in episode features: {sorted(feature_map)}")
    return image_key, img_feature


def load_tfrecord_trajectories(name: str, data_dir: Optional[str], split: str,
                               return_builder_info: bool = False):
    """TFDS-free RLDS loader: plain tf.data over the TFDS on-disk layout
    (TFRecord shards + dataset_info.json) — the episode proto schema the
    native C++ layer parses (data/native_pipeline.py docstring). Removes the
    `tensorflow_datasets` import from the real-data path; only TensorFlow
    itself is needed. Yields RESTRUCTURED trajectories
    {image, action, observation.state?, language} — the schema the built-in
    attack-dataset transforms consume; raw-schema OXE datasets go through
    `load_tfrecord_oxe_trajectories` instead."""
    tf = _tf()
    ds, builder_info, feature_map = _tfrecord_records(name, data_dir, split)
    image_key, img_feature = _image_feature(name, feature_map)
    lang_candidates = (
        "steps/language_instruction",
        "steps/observation/natural_language_instruction",
    )
    lang_feature = next((k for k in lang_candidates if k in feature_map), None)
    if lang_feature is None:
        raise KeyError(
            f"no language key {lang_candidates} in episode features: "
            f"{sorted(feature_map)}"
        )
    has_state = "steps/observation/state" in feature_map

    spec = {
        img_feature: tf.io.FixedLenSequenceFeature([], tf.string, allow_missing=True),
        "steps/action": tf.io.FixedLenSequenceFeature([], tf.float32, allow_missing=True),
        lang_feature: tf.io.FixedLenSequenceFeature([], tf.string, allow_missing=True),
    }
    if has_state:
        spec["steps/observation/state"] = tf.io.FixedLenSequenceFeature(
            [], tf.float32, allow_missing=True
        )

    def restructure(record):
        ex = tf.io.parse_single_example(record, spec)
        images = ex[img_feature]
        t = tf.shape(images)[0]
        out = {
            "image": images,
            "action": tf.reshape(ex["steps/action"], [t, -1]),
            "observation": {},
            "language": ex[lang_feature],
        }
        if has_state:
            out["observation"]["state"] = tf.reshape(ex["steps/observation/state"], [t, -1])
        return out

    mapped = ds.map(restructure, num_parallel_calls=tf.data.AUTOTUNE)
    if return_builder_info:
        return mapped, builder_info
    return mapped


def load_tfrecord_oxe_trajectories(name: str, data_dir: Optional[str], split: str,
                                   return_builder_info: bool = False):
    """Raw-schema OXE loader for the tfrecord layer: parses EVERY `steps/*`
    feature of the episode proto into the nested trajectory dict the OXE
    standardization transforms were written against (nested `action` dicts,
    arbitrary observation subkeys — the schema the reference's standardize_fn
    sees BEFORE restructuring, dataset.py:131-200), applies the registered
    transform, then restructures to the {image, action, observation,
    language} layout the frame pipeline consumes.

    Wire-format caveat: tf.Example flattens per-step tensors, so a [T] scalar
    and a flattened [T, 1] column are indistinguishable; float/int features
    whose length is a multiple of T decode as [T, k] with k > 1 and as [T]
    when the length equals T — the shapes the transform combinators accept
    (their gripper post-processors handle 1-D and 2-D)."""
    tf = _tf()
    ds, builder_info, feature_map = _tfrecord_records(name, data_dir, split)
    from .oxe_transforms import OXE_TRANSFORMS

    transform = OXE_TRANSFORMS[name]
    image_key, img_feature = _image_feature(name, feature_map)

    # static column width per feature (wire format flattens per-step tensors;
    # the width k is schema-constant): k == 1 decodes as a rank-1 [T] tensor
    # (the combinators' _as_col handles both), k > 1 as [T, k] — static ranks
    # so the transforms' Python-side `x.shape.ndims` dispatch works.
    # Widths are introspected over SEVERAL leading records and checked for
    # consistency (a dataset whose per-episode widths vary must raise, not
    # silently mis-reshape every trajectory after the first); a per-record
    # length assert in parse() then covers the unscanned tail of the split.
    kinds, widths = {}, {}
    scanned = 0
    maps = [feature_map] + [
        tf.train.Example.FromString(rec.numpy()).features.feature for rec in ds.take(7)
    ]
    for fm in maps:
        t = len(fm[img_feature].bytes_list.value)
        for key, feat in fm.items():
            if not key.startswith("steps/"):
                continue
            if feat.HasField("bytes_list"):
                kinds[key] = tf.string
                continue
            if feat.HasField("float_list"):
                kinds[key], n = tf.float32, len(feat.float_list.value)
            else:
                kinds[key], n = tf.int64, len(feat.int64_list.value)
            if t == 0 or n == 0:
                continue
            if n % t != 0:
                raise ValueError(
                    f"{name}: feature '{key}' has length {n}, not a multiple of "
                    f"the episode's T={t} (record {scanned}) — ragged or "
                    f"non-per-step feature; cannot infer a static column width"
                )
            k = n // t
            if key in widths and widths[key] != k:
                raise ValueError(
                    f"{name}: feature '{key}' width is inconsistent across "
                    f"records ({widths[key]} vs {k} at record {scanned}) — "
                    f"refusing to decode with a single static shape"
                )
            widths.setdefault(key, k)
        scanned += 1
    spec = {
        k: tf.io.FixedLenSequenceFeature([], dtype, allow_missing=True)
        for k, dtype in kinds.items()
    }

    def parse(record):
        ex = tf.io.parse_single_example(record, spec)
        t = tf.shape(ex[img_feature])[0]
        traj = {}
        for key, dtype in kinds.items():
            val = ex[key]
            if dtype != tf.string:
                k = widths.get(key, 1)
                # guard the records the introspection scan never saw: a
                # length mismatch is a loud per-dataset error, not a silent
                # wrong-shape trajectory
                val = tf.ensure_shape(val, [None])
                # empty (length 0) stays legal — optional features absent in
                # some records decoded as empty tensors before this guard and
                # must keep doing so; only a NON-empty wrong length is ragged
                n_elems = tf.shape(val)[0]
                check = tf.debugging.Assert(
                    tf.logical_or(tf.equal(n_elems, t * k), tf.equal(n_elems, 0)),
                    [
                        f"{name}: feature '{key}' length != T*{k} (and != 0) "
                        f"— ragged record beyond the width-introspection window; "
                        "length:",
                        n_elems, "T:", t,
                    ],
                )
                with tf.control_dependencies([check]):
                    val = tf.identity(val)
                if k > 1:
                    val = tf.reshape(val, [-1, k])
            # nest under the path after 'steps/'
            parts = key.split("/")[1:]
            node = traj
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        return traj

    def restructure(traj):
        obs = traj.get("observation", {})
        language = traj.get(
            "language_instruction", obs.get("natural_language_instruction")
        )
        if language is None:
            # raised at ds.map trace time (= loader build), mirroring
            # load_tfrecord_trajectories' explicit check — a None here would
            # otherwise surface much later as an opaque tf error in the frame
            # pipeline
            raise KeyError(
                f"{name}: transformed trajectory has no language key "
                f"('language_instruction' or 'observation/"
                f"natural_language_instruction'); transformed keys: "
                f"{sorted(traj)} / obs: {sorted(obs)}"
            )
        out = {
            "image": obs[image_key],
            "action": traj["action"],
            "observation": {},
            "language": language,
        }
        if "state" in obs:
            out["observation"]["state"] = obs["state"]
        return out

    mapped = ds.map(
        lambda rec: restructure(transform(parse(rec))),
        num_parallel_calls=tf.data.AUTOTUNE,
    )
    if return_builder_info:
        return mapped, builder_info
    return mapped


def make_frame_dataset(
    name: str,
    data_dir: Optional[str] = None,
    train: bool = True,
    image_size: int = 224,
    stats: Optional[Dict] = None,
    seed: int = 42,
    traj_dataset=None,
    shuffle_buffer: int = SHUFFLE_BUFFER,
    num_shards: int = 1,
    shard_index: int = 0,
    file_layer: str = "tf",
):
    """Full per-dataset pipeline: load -> standardize -> stats -> normalize ->
    frames. `traj_dataset` injects a pre-built trajectory dataset (tests).

    num_shards/shard_index: per-host trajectory sharding for multi-host DP
    (the reference DDP's `dataset.shard(world, rank)`, UADA_ddp.py:157-159).
    Statistics are computed over the UNsharded stream so every host
    normalizes identically.

    file_layer:
      'tf'       — TFDS builder read (requires tensorflow_datasets);
      'tfrecord' — plain tf.data over the TFDS on-disk layout
                   (load_tfrecord_trajectories; no tensorflow_datasets
                   dependency, exact percent splits via dataset_info.json);
      'native'   — the C++ reader (native/rlds_reader.cpp via
                   data/native_pipeline.py): TFRecord framing, proto parsing,
                   and JPEG decode run native with NumPy standardization — no
                   TensorFlow on the hot path. Requires `stats` (or a
                   tf-computed cache) and currently covers the attack
                   datasets (bridge_orig + LIBERO suites)."""
    if file_layer == "native":
        if stats is None:
            raise ValueError(
                "file_layer='native' needs `stats` (compute once with the tf "
                "layer or load a reference dataset_statistics.json)"
            )
        from .native_pipeline import NativeFrameDataset, discover_tfrecords

        paths = discover_tfrecords(name, data_dir or ".", split="train")
        if num_shards > 1:
            paths = paths[shard_index::num_shards] or paths[shard_index:shard_index + 1]
        frames = NativeFrameDataset(
            paths, name, stats, image_key=dataset_image_key(name),
            image_size=image_size, shuffle_buffer=shuffle_buffer, seed=seed, train=train,
        )
        return frames, stats
    split = "train[:95%]" if train else "train[95%:]"  # dataset.py:234-237
    builder_info = f"name={name}"
    loader, transform = None, STANDARDIZATION_TRANSFORMS.get(name)
    raw_oxe = (
        file_layer == "tfrecord"
        and name not in RESTRUCTURED_SCHEMA_DATASETS
        and transform is not None
    )
    if traj_dataset is None:
        if raw_oxe:
            # raw-schema OXE dataset: the transform is applied INSIDE the
            # loader, on the nested raw trajectory the reference's
            # standardize_fn sees (dataset.py:131-200)
            loader = load_tfrecord_oxe_trajectories
        elif file_layer == "tfrecord":
            loader = load_tfrecord_trajectories
        else:
            if name not in RESTRUCTURED_SCHEMA_DATASETS and transform is not None:
                raise NotImplementedError(
                    f"'{name}' has a raw-schema OXE transform; load it with "
                    "file_layer='tfrecord' (the TFDS layer here restructures "
                    "before the transform runs)"
                )
            loader = load_tfds_trajectories
        traj_dataset, builder_info = loader(
            name, data_dir, split, return_builder_info=True
        )
    if transform is not None and not raw_oxe:
        traj_dataset = traj_dataset.map(transform)
    if stats is None:
        import inspect

        # hash over builder info + transform SOURCE (dataset.py:213-220):
        # editing a standardization transform invalidates cached statistics.
        transform_src = inspect.getsource(transform) if transform is not None else ""
        if loader is not None:
            # the reference aggregates statistics over split="all"
            # (dataset.py:209-222) so train and val normalize identically
            # from ONE cache entry; 'train' == "all" for the attack datasets
            # (their builders carry no other split)
            stats_split = "train"
            stats_traj = loader(name, data_dir, stats_split)
            if transform is not None and not raw_oxe:  # raw path pre-applies it
                stats_traj = stats_traj.map(transform)
        else:  # injected trajectory dataset (tests/synthetic): use as-is
            stats_split, stats_traj = split, traj_dataset
        stats = compute_dataset_statistics(
            stats_traj, save_path=data_dir,
            hash_dependencies=(builder_info, stats_split, transform_src),
        )
    if num_shards > 1:
        traj_dataset = traj_dataset.shard(num_shards, shard_index)
    traj_dataset = traj_dataset.map(lambda t: normalize_traj_actions(t, stats))
    frames = trajectories_to_frames(
        traj_dataset, image_size, train=train, seed=seed, shuffle_buffer=shuffle_buffer
    )
    return frames, stats


def frames_to_attack_batches(
    frame_dataset,
    tokenizer: TextTokenizer,
    batch_size: int,
    pad_to: Optional[int] = 32,
    counters: Optional[Dict] = None,
) -> Iterator:
    """Host loop: tokenize prompts + collate into AttackBatch (the reference's
    RLDSBatchTransform + collator, done in the numpy iterator).

    Frames whose tokenization exceeds `pad_to` are SKIPPED with a warning
    (the 16 GB bs=8 7B envelope caps the multimodal sequence at 288, i.e.
    pad_to=32; a crash hours into a run would be worse than a slightly
    filtered instruction distribution — raise --pad_to on bigger chips).
    Pass a `counters` dict to observe the rate: 'frames_seen' and
    'frames_skipped_pad_to' are incremented in place so the run tracker can
    report a long-instruction dataset being quietly decimated."""
    it = frame_dataset.as_numpy_iterator()
    counters = counters if counters is not None else {}
    counters.setdefault("frames_seen", 0)
    counters.setdefault("frames_skipped_pad_to", 0)
    while True:
        rows = []
        while len(rows) < batch_size:
            f = next(it)
            counters["frames_seen"] += 1
            lang = f["language"]
            if isinstance(lang, bytes):
                lang = lang.decode()
            input_ids, labels = build_vla_example(lang, f["action"], tokenizer)
            if pad_to is not None and len(input_ids) > pad_to:
                counters["frames_skipped_pad_to"] += 1
                if counters["frames_skipped_pad_to"] in (1, 100, 10000):
                    print(f"[data] WARNING: skipped "
                          f"{counters['frames_skipped_pad_to']} frames with "
                          f"prompts longer than pad_to={pad_to} "
                          f"(latest: {len(input_ids)} tokens); raise --pad_to "
                          "if HBM allows")
                continue
            rows.append(dict(image=f["image"], input_ids=input_ids, labels=labels))
        yield collate(rows, pad_to=pad_to)


def make_attack_iterators(
    dataset: str,
    batch_size: int,
    seed: int = 42,
    checkpoint: Optional[str] = None,
    data_dir: Optional[str] = None,
    tokenizer: Optional[TextTokenizer] = None,
    pad_to: int = 32,
    num_shards: int = 1,
    shard_index: int = 0,
    counters: Optional[Dict] = None,
    stats_sink: Optional[Dict] = None,
    file_layer: str = "tf",
    stats: Optional[Dict] = None,
    shuffle_buffer: int = SHUFFLE_BUFFER,
    image_size: int = 224,
) -> Tuple[Iterator, Iterator]:
    """(train, val) AttackBatch iterators for a named RLDS dataset
    (openvla_dataloader.py:81-156 equivalent; val batch size fixed at 8).
    pad_to=32 (multimodal seq 288) is the 16 GB bs=8 7B fit envelope.
    num_shards/shard_index give each HOST a disjoint trajectory shard for
    multi-host data parallelism (pass the process count and index).
    `counters` (mutated in place) exposes the pad_to skip rate."""
    if tokenizer is None:  # local files only: never the network
        tokenizer = tokenizer_from_checkpoint(checkpoint)
    train_frames, stats = make_frame_dataset(
        dataset, data_dir, train=True, seed=seed, stats=stats,
        num_shards=num_shards, shard_index=shard_index, file_layer=file_layer,
        shuffle_buffer=shuffle_buffer, image_size=image_size,
    )
    val_frames, _ = make_frame_dataset(
        dataset, data_dir, train=False, stats=stats, seed=seed,
        num_shards=num_shards, shard_index=shard_index, file_layer=file_layer,
        shuffle_buffer=shuffle_buffer, image_size=image_size,
    )
    if stats_sink is not None:
        stats_sink[dataset] = stats
    train = frames_to_attack_batches(train_frames, tokenizer, batch_size,
                                     pad_to=pad_to, counters=counters)
    val = frames_to_attack_batches(val_frames, tokenizer, 8, pad_to=pad_to)
    return train, val


def make_interleaved_frame_dataset(
    mixture: Dict[str, float],
    data_dir: Optional[str] = None,
    train: bool = True,
    image_size: int = 224,
    seed: int = 42,
    traj_datasets: Optional[Dict[str, object]] = None,
    shuffle_buffer: int = SHUFFLE_BUFFER,
    file_layer: str = "tf",
):
    """Weighted multi-dataset frame stream (make_interleaved_dataset,
    rlds/dataset.py:457-588): per-dataset pipelines sampled by normalized
    weight via tf.data.Dataset.sample_from_datasets. `file_layer` as in
    make_frame_dataset ('tf' = TFDS builder, 'tfrecord' = plain tf.data over
    the on-disk shards)."""
    tf = _tf()
    names = list(mixture)
    weights = np.asarray([mixture[n] for n in names], np.float64)
    weights = (weights / weights.sum()).tolist()
    streams, stats = [], {}
    for name in names:
        frames, st = make_frame_dataset(
            name, data_dir, train=train, image_size=image_size, seed=seed,
            traj_dataset=(traj_datasets or {}).get(name),
            shuffle_buffer=max(shuffle_buffer // max(len(names), 1), 1),
            file_layer=file_layer,
        )
        frames = frames.map(lambda f, n=name: dict(f, dataset_name=tf.constant(n)))
        streams.append(frames)
        stats[name] = st
    mixed = tf.data.Dataset.sample_from_datasets(streams, weights=weights, seed=seed)
    return mixed.prefetch(tf.data.AUTOTUNE), stats


def episodic_iterator(traj_dataset, image_size: int = 224):
    """Whole-trajectory iteration (EpisodicRLDSDataset equivalent,
    prismatic/vla/datasets/datasets.py:168-189): yields dicts with all frames
    of one episode, decoded/resized."""
    tf = _tf()
    ds = traj_dataset.map(
        lambda t: dict(
            t,
            image=tf.map_fn(
                lambda im: decode_and_resize(im, image_size), t["image"],
                fn_output_signature=tf.uint8,
            ),
        ),
        num_parallel_calls=tf.data.AUTOTUNE,
    )
    yield from ds.as_numpy_iterator()


def augment_frame(frame: Dict, seed, augment_kwargs: Dict):
    """Training-time image augmentations (obs_transforms.py:17-43 /
    RLDSDataset config, datasets.py:126-139): random_resized_crop + photometric
    jitter in a caller-specified order, stateless-seeded."""
    tf = _tf()
    image = tf.image.convert_image_dtype(frame["image"], tf.float32)
    seeds = tf.unstack(
        tf.random.experimental.stateless_split(seed, num=len(augment_kwargs.get("augment_order", [])) + 1)
    )
    for i, op in enumerate(augment_kwargs.get("augment_order", [])):
        s = seeds[i]
        if op == "random_resized_crop":
            cfg = augment_kwargs["random_resized_crop"]
            h, w = image.shape[0], image.shape[1]
            scale = tf.random.stateless_uniform(
                [], s, cfg["scale"][0], cfg["scale"][1]
            )
            ratio = tf.random.stateless_uniform(
                [], s + 1, cfg["ratio"][0], cfg["ratio"][1]
            )
            ch = tf.cast(tf.sqrt(scale / ratio) * tf.cast(h, tf.float32), tf.int32)
            cw = tf.cast(tf.sqrt(scale * ratio) * tf.cast(w, tf.float32), tf.int32)
            ch = tf.minimum(ch, h)
            cw = tf.minimum(cw, w)
            image = tf.image.stateless_random_crop(image, [ch, cw, 3], seed=s)
            image = tf.image.resize(image, (h, w), method="lanczos3", antialias=True)
        elif op == "random_brightness":
            image = tf.image.stateless_random_brightness(
                image, augment_kwargs["random_brightness"][0], seed=s
            )
        elif op == "random_contrast":
            lo, hi = augment_kwargs["random_contrast"]
            image = tf.image.stateless_random_contrast(image, lo, hi, seed=s)
        elif op == "random_saturation":
            lo, hi = augment_kwargs["random_saturation"]
            image = tf.image.stateless_random_saturation(image, lo, hi, seed=s)
        elif op == "random_hue":
            image = tf.image.stateless_random_hue(
                image, augment_kwargs["random_hue"][0], seed=s
            )
        else:
            raise ValueError(f"unknown augmentation '{op}'")
    image = tf.clip_by_value(image, 0.0, 1.0)
    return dict(frame, image=tf.image.convert_image_dtype(image, tf.uint8, saturate=True))


# the reference's default VLA augmentation config (datasets.py:128-139)
DEFAULT_AUGMENT_KWARGS = dict(
    random_resized_crop=dict(scale=[0.9, 0.9], ratio=[1.0, 1.0]),
    random_brightness=[0.2],
    random_contrast=[0.8, 1.2],
    random_saturation=[0.8, 1.2],
    random_hue=[0.05],
    augment_order=[
        "random_resized_crop", "random_brightness", "random_contrast",
        "random_saturation", "random_hue",
    ],
)


def with_augmentations(frame_dataset, augment_kwargs: Optional[Dict] = None, seed: int = 0):
    """Map stateless-seeded augmentations over an (already decoded) frame
    stream; only applied at train time, like apply_frame_transforms."""
    tf = _tf()
    kwargs = augment_kwargs or DEFAULT_AUGMENT_KWARGS
    ds = frame_dataset.enumerate()
    return ds.map(
        lambda i, f: augment_frame(
            f, tf.stack([tf.cast(i, tf.int32), tf.constant(seed, tf.int32)]), kwargs
        ),
        num_parallel_calls=tf.data.AUTOTUNE,
    )
