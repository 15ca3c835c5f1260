"""The port's RLDS pipeline (`data/rlds.py`) and the helpers it needs (the
q99 action normalization, the action-token encoder) against the JAX
package's, on injected in-memory trajectories: the gripper primitives, the
standardization transforms, the statistics and their cache key, the frame
pipeline, the attack batches, mixtures, episodes, augmentations and host
sharding.

Tolerances: frames, actions, token ids, labels and statistics exact (the
same tf ops and numpy code on the same inputs); the q99 helpers exact on
numpy and within 1 f32 ulp (rtol 2^-23) on torch tensors against jnp (both
IEEE f32 ops, evaluated by another library)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from roboticattack_tpu.data import rlds as jr
from roboticattack_tpu.utils import action_tokenizer as jat
from roboticattack_tpu.utils import normalization as jnorm
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.data import rlds as tr
from roboticattack_torch.utils import action_tokenizer as tat
from roboticattack_torch.utils import normalization as tnorm
from roboticattack_torch.utils.prompting import WordStubTokenizer

from test_rlds_pipeline import _synthetic_traj_dataset as traj_ds

# read before any fixture moves them
HOME_CACHES = {"jax": jr.LOCAL_STATS_CACHE, "torch": tr.LOCAL_STATS_CACHE}
from test_torch_data_tfrecord import assert_tree_equal, isolated_stats_cache, take  # noqa: F401


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("masked", [False, True])
def test_q99_normalization_equal(masked):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((16, 7)) * 2).astype(np.float32)
    q01 = rng.uniform(-1.5, -0.5, 7).astype(np.float32)
    q99 = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    q99[3] = q01[3]  # a constant dim: the 1e-8 guard
    mask = np.array([True] * 6 + [False]) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    for name in ("normalize_actions_q99", "unnormalize_actions_q99"):
        want = np.asarray(getattr(jnorm, name)(jnp.asarray(a), jnp.asarray(q01), jnp.asarray(q99), jmask))
        got_np = getattr(tnorm, name)(a, q01, q99, mask)
        assert isinstance(got_np, np.ndarray) and got_np.dtype == np.float32
        np.testing.assert_array_equal(got_np, want)
        got_t = getattr(tnorm, name)(torch.from_numpy(a), torch.from_numpy(q01), torch.from_numpy(q99),
                                     None if mask is None else torch.from_numpy(mask))
        assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32
        np.testing.assert_allclose(got_t.numpy(), want, rtol=2.0 ** -23, atol=0)


def test_encode_actions_and_token_string_equal():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(-1.2, 1.2, 200), [-1.0, 0.0, 1.0, -1.0 + 2 / 255, np.nextafter(1.0, 0)]])
    a = a.astype(np.float32).reshape(-1, 5)
    got = tat.encode_actions(torch.from_numpy(a))
    want = np.asarray(jat.encode_actions(jnp.asarray(a)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tat.action_token_string(a[0]) == jat.action_token_string(a[0])


# ------------------------------------------------------------------ tf primitives
def test_gripper_primitives_equal():
    rng = np.random.default_rng(2)
    grip = tf.constant(rng.choice([0.0, 0.03, 0.3, 0.5, 0.7, 0.97, 1.0], 50), tf.float32)
    np.testing.assert_array_equal(tr.binarize_gripper_actions(grip).numpy(),
                                  jr.binarize_gripper_actions(grip).numpy())
    rel = tf.constant(rng.choice([-1.0, -0.05, 0.0, 0.05, 1.0], 50), tf.float32)
    np.testing.assert_array_equal(tr.rel2abs_gripper_actions(rel).numpy(),
                                  jr.rel2abs_gripper_actions(rel).numpy())
    np.testing.assert_array_equal(tr.invert_gripper_actions(grip).numpy(),
                                  jr.invert_gripper_actions(grip).numpy())


@pytest.mark.parametrize("name", ["bridge_orig", "libero_spatial_no_noops"])
def test_standardization_and_normalization_equal(name):
    want_std = [jr.STANDARDIZATION_TRANSFORMS[name](dict(t)) for t in traj_ds(n_traj=3, traj_len=9)]
    got_std = [tr.STANDARDIZATION_TRANSFORMS[name](dict(t)) for t in traj_ds(n_traj=3, traj_len=9)]
    for g, w in zip(got_std, want_std):
        assert_tree_equal(tf.nest.map_structure(np.asarray, g), tf.nest.map_structure(np.asarray, w))
    wstats = jr.compute_dataset_statistics(traj_ds(n_traj=3, traj_len=9).map(jr.STANDARDIZATION_TRANSFORMS[name]))
    gstats = tr.compute_dataset_statistics(traj_ds(n_traj=3, traj_len=9).map(tr.STANDARDIZATION_TRANSFORMS[name]))
    assert gstats == wstats
    for g, w in zip(got_std, want_std):
        np.testing.assert_array_equal(tr.normalize_traj_actions(g, gstats)["action"].numpy(),
                                      jr.normalize_traj_actions(w, wstats)["action"].numpy())


def test_statistics_cache_key_and_directory(tmp_path):
    deps = ("builder-info", "train", "def transform(t): return t")
    assert tr.statistics_cache_path(deps, str(tmp_path)) == jr.statistics_cache_path(deps, str(tmp_path))
    # the port's own cache directory: never one the JAX package wrote
    assert HOME_CACHES["torch"] != HOME_CACHES["jax"]
    assert HOME_CACHES["torch"] == os.path.expanduser(os.path.join("~", ".cache", "roboticattack_torch"))
    ds = traj_ds(n_traj=2, traj_len=6)
    stats = tr.compute_dataset_statistics(ds, save_path=str(tmp_path), hash_dependencies=deps)
    assert os.path.isfile(tr.statistics_cache_path(deps, str(tmp_path)))
    again = tr.compute_dataset_statistics(traj_ds(n_traj=5, traj_len=6), save_path=str(tmp_path),
                                          hash_dependencies=deps)
    assert again == stats and stats["num_trajectories"] == 2  # read back, not recomputed


# ------------------------------------------------------------------ frames and batches
@pytest.mark.parametrize("train,shuffle", [(True, 32), (False, 1)])
def test_injected_pipeline_frames_equal(train, shuffle):
    kw = dict(train=train, image_size=48, seed=0, shuffle_buffer=shuffle)
    wframes, wstats = jr.make_frame_dataset("bridge_orig", traj_dataset=traj_ds(n_traj=3, traj_len=8), **kw)
    gframes, gstats = tr.make_frame_dataset("bridge_orig", traj_dataset=traj_ds(n_traj=3, traj_len=8), **kw)
    assert gstats == wstats
    for g, w in zip(take(gframes, 36), take(wframes, 36)):
        assert_tree_equal(g, w)


def test_frames_to_attack_batches_equal():
    out = []
    for mod, tok in ((jr, JaxStub()), (tr, WordStubTokenizer())):
        frames, _ = mod.make_frame_dataset("bridge_orig", image_size=56, seed=1, shuffle_buffer=16,
                                           traj_dataset=traj_ds(n_traj=3, traj_len=8, image_size=40))
        counters = {}
        it = mod.frames_to_attack_batches(frames, tok, batch_size=4, pad_to=40, counters=counters)
        out.append(([next(it) for _ in range(3)], counters))
    (want, wc), (got, gc) = out
    assert gc == wc == {"frames_seen": 12, "frames_skipped_pad_to": 0}
    for g, w in zip(got, want):
        for name, a, b in zip(g._fields, g, w):
            assert a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_make_attack_iterators_with_injected_frames(monkeypatch):
    """make_attack_iterators' wiring (train at bs, val at 8, the statistics
    of the train stream reused for val, the stats sink, the counters on the
    train stream only) over the same injected trajectories."""
    out = {}
    for key, mod, tok in (("jax", jr, JaxStub()), ("torch", tr, WordStubTokenizer())):
        def injected(name, data_dir=None, train=True, stats=None, seed=42, real=mod.make_frame_dataset, **kw):
            return real(name, train=train, stats=stats, image_size=kw["image_size"], seed=seed,
                        shuffle_buffer=8, traj_dataset=traj_ds(n_traj=2, traj_len=7, seed=int(train)))

        monkeypatch.setattr(mod, "make_frame_dataset", injected)
        counters, sink = {}, {}
        train, val = mod.make_attack_iterators("bridge_orig", 2, seed=3, tokenizer=tok, pad_to=40,
                                               counters=counters, stats_sink=sink, image_size=48)
        out[key] = ([next(train), next(train), next(val)], counters, sink)
    (got, gc, gs), (want, wc, ws) = out["torch"], out["jax"]
    assert gc == wc == {"frames_seen": 4, "frames_skipped_pad_to": 0}
    assert gs == ws and list(gs) == ["bridge_orig"]
    assert got[0].images.shape[0] == 2 and got[2].images.shape[0] == 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_interleaved_mixture_in_memory_equal():
    mix = {"bridge_orig": 0.7, "libero_goal_no_noops": 0.3}
    out = []
    for mod in (jr, tr):
        frames, stats = mod.make_interleaved_frame_dataset(
            mix, image_size=40, shuffle_buffer=16, seed=0,
            traj_datasets={"bridge_orig": traj_ds(n_traj=2, traj_len=6, seed=1, image_size=36),
                           "libero_goal_no_noops": traj_ds(n_traj=2, traj_len=6, seed=2, image_size=36)})
        out.append((take(frames, 30), stats))
    (want, ws), (got, gs) = out
    assert gs == ws
    for g, w in zip(got, want):
        assert_tree_equal(g, w)


def test_episodic_iterator_and_augmentations_equal():
    want = list(jr.episodic_iterator(traj_ds(n_traj=2, traj_len=5, image_size=30), image_size=48))
    got = list(tr.episodic_iterator(traj_ds(n_traj=2, traj_len=5, image_size=30), image_size=48))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_tree_equal(g, w)
    out = []
    for mod in (jr, tr):
        frames, _ = mod.make_frame_dataset("bridge_orig", image_size=64, seed=0, shuffle_buffer=16,
                                           traj_dataset=traj_ds(n_traj=2, traj_len=6, image_size=40))
        out.append(take(mod.with_augmentations(frames, seed=1), 6))
    for g, w in zip(out[1], out[0]):
        assert_tree_equal(g, w)


@pytest.mark.parametrize("shard_index", [0, 1])
def test_host_sharding_equal(shard_index):
    out = []
    for mod in (jr, tr):
        frames, stats = mod.make_frame_dataset(
            "bridge_orig", image_size=32, seed=0, shuffle_buffer=1, num_shards=2, shard_index=shard_index,
            traj_dataset=traj_ds(n_traj=4, traj_len=6, image_size=30))
        out.append((take(frames, 8), stats))
    (want, ws), (got, gs) = out
    assert gs == ws
    for g, w in zip(got, want):
        assert_tree_equal(g, w)


def test_tf_file_layer_needs_tensorflow_datasets_as_jax():
    for mod in (jr, tr):
        with pytest.raises(ImportError, match="tensorflow_datasets"):
            mod.load_tfds_trajectories("bridge_orig", None, "train")
