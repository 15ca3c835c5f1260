"""The port's tfrecord file layer against the JAX package's on the same
episodes: the shard writer, split parsing and boundaries, trajectories,
statistics, the first 64 frames, the first attack batches, raw-schema OXE
datasets, mixtures, and the first batch through the tiny model's forward.

Each package writes its own layout from the same numpy seed and reads it
back, so each computes (and caches, under its own data dir) its own
statistics. Tolerances: frames, actions, languages, token ids, labels,
statistics and shard bytes exact (the same tf ops on the same bytes); the
forward's CE at FWD_TOL of tests/test_torch_attack.py (f32 sums in another
order over the layers)."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from roboticattack_tpu.data import rlds as jr
from roboticattack_tpu.data import synthetic_shards as jss
from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.models import vlm as jvlm
from roboticattack_tpu.utils.normalization import dual_normalize as jdual
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.data import rlds as tr
from roboticattack_torch.data import synthetic_shards as tss
from roboticattack_torch.models import vlm as tvlm
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.utils.prompting import WordStubTokenizer

from test_tfrecord_layer import _write_raw_oxe_layout

T = 6
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def isolated_stats_cache(tmp_path, monkeypatch):
    """Each package's home statistics cache moved under tmp_path, apart: a
    cache an earlier run wrote (keyed on the dataset info, the split and the
    transform's source) must not answer for this test's data."""
    monkeypatch.setattr(jr, "LOCAL_STATS_CACHE", str(tmp_path / "jax_home_cache"))
    monkeypatch.setattr(tr, "LOCAL_STATS_CACHE", str(tmp_path / "torch_home_cache"))


def write_both(root, seed=0, **kw):
    """The same layout written by each package's writer from `seed`, under
    root/jax and root/torch; returns the two data dirs."""
    dirs = {}
    for pkg, mod in (("jax", jss), ("torch", tss)):
        dirs[pkg] = str(root / pkg)
        mod.write_rlds_layout(dirs[pkg], rng=np.random.default_rng(seed), **{"steps": T, **kw})
    return dirs["jax"], dirs["torch"]


def assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}/{k}")
    else:
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)


def take(ds, n):
    it = ds.as_numpy_iterator()
    return [next(it) for _ in range(n)]


def redeterministic(path):
    """The records of a TFRecord file re-serialized with protobuf's
    deterministic (key-ordered) map encoding and framed by TensorFlow."""
    out = path + ".det"
    with tf.io.TFRecordWriter(out) as w:
        for rec in tf.data.TFRecordDataset(path):
            w.write(tf.train.Example.FromString(rec.numpy()).SerializeToString(deterministic=True))
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kw", [dict(n_episodes=4, n_shards=2, image_key="image_0", image_size=32),
                                dict(n_episodes=3, n_shards=1, image_key="image", image_size=48,
                                     language=b"put the cup on the plate")])
def test_shard_writer_bytes_equal_jax(tmp_path, kw):
    """Each shard's bytes equal the JAX writer's with its Examples in
    protobuf's deterministic encoding (TF orders map entries by a hash
    seeded per process); the records parse to equal Examples, and
    dataset_info.json is the same file."""
    jdir, tdir = write_both(tmp_path, seed=5, **kw)
    vdir = os.path.join("bridge_orig", "1.0.0")
    names = sorted(os.listdir(os.path.join(jdir, vdir)))
    assert names == sorted(os.listdir(os.path.join(tdir, vdir)))
    for name in names:
        jp, tp = os.path.join(jdir, vdir, name), os.path.join(tdir, vdir, name)
        with open(tp, "rb") as f:
            got = f.read()
        if name == "dataset_info.json":
            with open(jp, "rb") as f:
                assert got == f.read()
            continue
        assert got == redeterministic(jp)
        for a, b in zip(tf.data.TFRecordDataset(tp), tf.data.TFRecordDataset(jp)):
            assert tf.train.Example.FromString(a.numpy()) == tf.train.Example.FromString(b.numpy())


def test_crc32c_and_frame(tmp_path):
    assert tss.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert tss.crc32c(b"") == 0
    payload = np.random.default_rng(1).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    path = str(tmp_path / "frame.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        w.write(payload)
    with open(path, "rb") as f:
        assert tss.tfrecord_frame(payload) == f.read()


@pytest.mark.parametrize("split", ["train", "train[:95%]", "train[95%:]", "val[10%:60%]", "train[:]"])
def test_parse_split_equal(split):
    assert tr._parse_split(split) == jr._parse_split(split)


@pytest.mark.parametrize("split", ["train[weird]", "train[:1000]", "train[50%:200%]"])
def test_parse_split_refusals_equal(split):
    for mod in (jr, tr):
        with pytest.raises(ValueError):
            mod._parse_split(split)


@pytest.mark.parametrize("with_info,split", [(True, "train"), (True, "train[:95%]"), (True, "train[95%:]"),
                                             (False, "train[:95%]"), (False, "train[10%:15%]")])
def test_tfrecord_trajectories_equal(tmp_path, with_info, split):
    """Exact percent splits from dataset_info.json (20 episodes in 2 shards:
    19 + 1) and the index-modulus fallback without it (i % 100 in [lo, hi))."""
    jdir, tdir = write_both(tmp_path, n_episodes=20, n_shards=2, with_info=with_info)
    want, winfo = jr.load_tfrecord_trajectories("bridge_orig", jdir, split, return_builder_info=True)
    got, ginfo = tr.load_tfrecord_trajectories("bridge_orig", tdir, split, return_builder_info=True)
    assert ginfo == winfo
    want, got = list(want.as_numpy_iterator()), list(got.as_numpy_iterator())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_tree_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_first_64_frames_and_stats_equal(tmp_path, train):
    """make_frame_dataset(file_layer='tfrecord') with statistics computed
    from the shards: the same statistics, and the same first 64 frames in
    the same shuffled order (train) or storage order (val)."""
    jdir, tdir = write_both(tmp_path, n_episodes=20, image_size=40)
    kw = dict(train=train, image_size=56, seed=3, shuffle_buffer=16, file_layer="tfrecord")
    wframes, wstats = jr.make_frame_dataset("bridge_orig", jdir, **kw)
    gframes, gstats = tr.make_frame_dataset("bridge_orig", tdir, **kw)
    assert gstats == wstats and gstats["num_trajectories"] == 20
    # each package cached its statistics under its own data dir
    assert any(f.startswith("dataset_statistics_") for f in os.listdir(tdir))
    for g, w in zip(take(gframes, 64), take(wframes, 64)):
        assert_tree_equal(g, w)


def test_oxe_image_key_layout_equal(tmp_path):
    """A registered OXE dataset reads through its registry camera key."""
    assert tr.dataset_image_key("taco_play") == jr.dataset_image_key("taco_play") == "rgb_static"
    assert tr.dataset_image_key("unregistered") == "image"
    jdir, tdir = write_both(tmp_path, n_episodes=2, name="taco_play", image_key="rgb_static")
    want = list(jr.load_tfrecord_trajectories("taco_play", jdir, "train").as_numpy_iterator())
    got = list(tr.load_tfrecord_trajectories("taco_play", tdir, "train").as_numpy_iterator())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_tree_equal(g, w)


RAW_OXE = {
    "taco_play": lambda: {
        "steps/observation/rgb_static": lambda r: [jss.jpeg_bytes(r, 32) for _ in range(T)],
        "steps/observation/robot_obs": lambda r: r.standard_normal((T, 15)),
        "steps/observation/natural_language_instruction": lambda r: [b"wipe the table"] * T,
        "steps/action/rel_actions_world": lambda r: r.standard_normal((T, 7)),
    },
    "fractal20220817_data": lambda: {
        "steps/observation/image": lambda r: [jss.jpeg_bytes(r, 32) for _ in range(T)],
        "steps/observation/natural_language_instruction": lambda r: [b"pick rxbar"] * T,
        "steps/action/world_vector": lambda r: r.standard_normal((T, 3)),
        "steps/action/rotation_delta": lambda r: r.standard_normal((T, 3)),
        "steps/action/gripper_closedness_action": lambda r: r.uniform(-1, 1, T),
    },
}


@pytest.mark.parametrize("name", sorted(RAW_OXE))
def test_raw_oxe_dataset_frames_equal(tmp_path, name):
    """A raw-schema OXE dataset on the tfrecord layer: the registered
    transform on the nested raw trajectory, then the frame pipeline; one
    layout, copied so each package caches its statistics apart."""
    _write_raw_oxe_layout(tmp_path / "jax", name, RAW_OXE[name](), n_episodes=4)
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    kw = dict(train=True, image_size=56, seed=1, shuffle_buffer=4, file_layer="tfrecord")
    wframes, wstats = jr.make_frame_dataset(name, str(tmp_path / "jax"), **kw)
    gframes, gstats = tr.make_frame_dataset(name, str(tmp_path / "torch"), **kw)
    assert gstats == wstats
    for g, w in zip(take(gframes, 16), take(wframes, 16)):
        assert_tree_equal(g, w)


def test_raw_oxe_ragged_width_raises_as_jax(tmp_path):
    widths = {"jax": iter([15, 14, 15]), "torch": iter([15, 14, 15])}
    for pkg, mod in (("jax", jr), ("torch", tr)):
        feats = dict(RAW_OXE["taco_play"](),
                     **{"steps/observation/robot_obs": lambda r, w=widths[pkg]: r.standard_normal((T, next(w)))})
        _write_raw_oxe_layout(tmp_path / pkg, "taco_play", feats)
        with pytest.raises(ValueError, match="inconsistent across"):
            mod.load_tfrecord_oxe_trajectories("taco_play", str(tmp_path / pkg), "train")


def test_empty_split_and_empty_first_shard_as_jax(tmp_path):
    for pkg, mod in (("jax", jr), ("torch", tr)):
        d = tmp_path / pkg / "bridge_orig" / "1.0.0"
        d.mkdir(parents=True)
        open(d / "bridge_orig-train.tfrecord-00000-of-00001", "wb").close()
        with pytest.raises(ValueError, match="no records"):
            mod.load_tfrecord_trajectories("bridge_orig", str(tmp_path / pkg), "train")
    jdir, tdir = write_both(tmp_path / "lead", n_episodes=4)
    for data_dir in (jdir, tdir):
        d = os.path.join(data_dir, "bridge_orig", "1.0.0")
        os.rename(os.path.join(d, "bridge_orig-train.tfrecord-00000-of-00001"),
                  os.path.join(d, "bridge_orig-train.tfrecord-00001-of-00002"))
        open(os.path.join(d, "bridge_orig-train.tfrecord-00000-of-00002"), "wb").close()
        with open(os.path.join(d, "dataset_info.json"), "w") as f:
            json.dump({"name": "bridge_orig", "splits": [{"name": "train", "shardLengths": ["0", "4"]}]}, f)
    want = list(jr.load_tfrecord_trajectories("bridge_orig", jdir, "train").as_numpy_iterator())
    got = list(tr.load_tfrecord_trajectories("bridge_orig", tdir, "train").as_numpy_iterator())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_tree_equal(g, w)


def test_interleaved_mixture_from_disk_equal(tmp_path):
    dirs = {}
    for pkg, mod in (("jax", jss), ("torch", tss)):
        dirs[pkg] = str(tmp_path / pkg)
        rng = np.random.default_rng(2)
        mod.write_rlds_layout(dirs[pkg], n_episodes=20, steps=T, rng=rng)
        mod.write_rlds_layout(dirs[pkg], n_episodes=20, steps=T, rng=rng,
                              name="libero_goal_no_noops", image_key="image")
    kw = dict(image_size=40, shuffle_buffer=4, file_layer="tfrecord", seed=0)
    mix = {"bridge_orig": 3.0, "libero_goal_no_noops": 1.0}
    want, wstats = jr.make_interleaved_frame_dataset(mix, data_dir=dirs["jax"], **kw)
    got, gstats = tr.make_interleaved_frame_dataset(mix, data_dir=dirs["torch"], **kw)
    assert gstats == wstats
    frames = take(got, 40)
    for g, w in zip(frames, take(want, 40)):
        assert_tree_equal(g, w)
    assert {f["dataset_name"] for f in frames} == {b"bridge_orig", b"libero_goal_no_noops"}


@pytest.fixture(scope="module")
def attack_batches(tmp_path_factory):
    """The first train and val batches of make_attack_iterators on the
    tfrecord layer, from each package's own 20-episode layout."""
    root = tmp_path_factory.mktemp("iters")
    jdir, tdir = write_both(root, n_episodes=20, image_size=48)
    out = {}
    for pkg, mod, tok, data_dir in (("jax", jr, JaxStub(), jdir), ("torch", tr, WordStubTokenizer(), tdir)):
        counters, sink = {}, {}
        train, val = mod.make_attack_iterators(
            "bridge_orig", 3, seed=4, data_dir=data_dir, tokenizer=tok, pad_to=40,
            counters=counters, stats_sink=sink, file_layer="tfrecord", shuffle_buffer=16,
            image_size=56)
        out[pkg] = dict(train=[next(train) for _ in range(2)], val=next(val), counters=counters, sink=sink)
    return out


def test_first_attack_batches_equal(attack_batches):
    want, got = attack_batches["jax"], attack_batches["torch"]
    assert got["counters"] == want["counters"] == {"frames_seen": 6, "frames_skipped_pad_to": 0}
    assert got["sink"] == want["sink"] and list(got["sink"]) == ["bridge_orig"]
    for g, w in zip(got["train"] + [got["val"]], want["train"] + [want["val"]]):
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            assert a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert got["train"][0].images.shape == (3, 56, 56, 3) and got["val"].images.shape[0] == 8


def test_data_batch_through_the_tiny_forward(attack_batches):
    """The slice end to end on the CPU: the first tfrecord-layer batch of
    each package through its own vla_forward on VLA_TINY (f32), the port's
    weights converted from the JAX draw."""
    jparams = jax.device_get(init_vla_params(jax.random.key(7), VLA_TINY))
    jb, tb = attack_batches["jax"]["train"][0], attack_batches["torch"]["train"][0]
    want = jvlm.vla_forward(jparams, VLA_TINY, jnp.asarray(jb.input_ids), jnp.asarray(jb.attention_mask),
                            jdual(jnp.asarray(jb.images)), jnp.asarray(jb.labels))
    from roboticattack_torch.utils.normalization import dual_normalize

    got = tvlm.vla_forward(params_from_jax(jparams), T_TINY, torch.as_tensor(tb.input_ids).long(),
                           torch.as_tensor(tb.attention_mask).long(),
                           dual_normalize(torch.as_tensor(tb.images)), torch.as_tensor(tb.labels).long())
    np.testing.assert_allclose(got.loss.item(), float(want.loss), **FWD_TOL)
    assert np.isfinite(got.loss.item()) and got.loss.item() > 5.0
