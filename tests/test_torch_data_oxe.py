"""The port's OXE registry, OXE standardization transforms and trajectory
transforms against the JAX package's.

Every registered transform gets the same raw trajectory (the schema table of
tests/test_oxe_transforms.py, drawn twice from one numpy seed) in both
packages; every output leaf must be equal. The registry's configs, mixtures
and per-dataset kwargs must be equal, with functions compared by name. The
random trajectory transforms run after the same tf global seed. Tolerance:
exact everywhere (the same tf ops on the same inputs)."""

import dataclasses

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import test_oxe_transforms as jt
import test_traj_transforms as jtt
from roboticattack_tpu.data import oxe_registry as jreg
from roboticattack_tpu.data import oxe_transforms as jox
from roboticattack_tpu.data import rlds as jr
from roboticattack_tpu.data import traj_transforms as jtraj
from roboticattack_torch.data import oxe_registry as treg
from roboticattack_torch.data import oxe_transforms as tox
from roboticattack_torch.data import rlds as tr
from roboticattack_torch.data import traj_transforms as ttraj


def plain(x):
    """Tensors -> numpy, functions -> their qualified name, dataclasses ->
    dicts, recursively, so two packages' outputs compare with ==."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if dataclasses.is_dataclass(x):
        return plain(dataclasses.asdict(x))
    if callable(x) and hasattr(x, "__qualname__"):
        return ("fn", x.__qualname__)
    if isinstance(x, (tf.Tensor, tf.Variable)):
        return x.numpy()
    return x


def assert_equal(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def raw_traj(monkeypatch, name, seed):
    monkeypatch.setattr(jt, "_RNG", np.random.default_rng(seed))
    return jt.SCHEMAS[name]()


def test_the_same_transforms_are_registered():
    assert sorted(tox.OXE_TRANSFORMS) == sorted(jox.OXE_TRANSFORMS)
    assert sorted(tr.STANDARDIZATION_TRANSFORMS) == sorted(jr.STANDARDIZATION_TRANSFORMS)
    assert tr.RESTRUCTURED_SCHEMA_DATASETS == jr.RESTRUCTURED_SCHEMA_DATASETS
    for name, fn in tr.STANDARDIZATION_TRANSFORMS.items():
        assert fn.__module__.startswith("roboticattack_torch."), name
        assert fn.__qualname__ == jr.STANDARDIZATION_TRANSFORMS[name].__qualname__, name


@pytest.mark.parametrize("name", sorted(jox.OXE_TRANSFORMS))
def test_transform_equal(monkeypatch, name):
    seed = sorted(jox.OXE_TRANSFORMS).index(name)
    # the same tf global seed before each package's call: a transform that
    # draws from tf.random (droid's view swap) then draws the same value
    tf.random.set_seed(seed)
    want = plain(jox.OXE_TRANSFORMS[name](raw_traj(monkeypatch, name, seed)))
    tf.random.set_seed(seed)
    got = plain(tox.OXE_TRANSFORMS[name](raw_traj(monkeypatch, name, seed)))
    assert_equal(got, want, name)
    assert got["action"].dtype == np.float32 and np.isfinite(got["action"]).all()


def test_registry_configs_and_mixtures_equal():
    assert sorted(treg.OXE_DATASET_CONFIGS) == sorted(jreg.OXE_DATASET_CONFIGS)
    for name, cfg in jreg.OXE_DATASET_CONFIGS.items():
        assert plain(treg.OXE_DATASET_CONFIGS[name]) == plain(cfg), name
    assert treg.OXE_NAMED_MIXTURES == jreg.OXE_NAMED_MIXTURES
    for mixture in jreg.OXE_NAMED_MIXTURES:
        got = treg.make_interleaved_mixture_kwargs(mixture, data_dir="/d")
        want = jreg.make_interleaved_mixture_kwargs(mixture, data_dir="/d")
        assert plain(got) == plain(want), mixture


@pytest.mark.parametrize("kw", [dict(), dict(load_camera_views=("primary", "wrist"), load_depth=True),
                                dict(load_proprio=False, load_language=False)])
def test_dataset_kwargs_equal(kw):
    for name in jreg.OXE_DATASET_CONFIGS:
        try:
            want = jreg.make_oxe_dataset_kwargs(name, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                treg.make_oxe_dataset_kwargs(name, **kw)
            continue
        assert plain(treg.make_oxe_dataset_kwargs(name, **kw)) == plain(want), name
    for mod in (treg, jreg):
        with pytest.raises(KeyError):
            mod.make_oxe_dataset_kwargs("no_such_dataset")


def test_quat_to_euler_and_droid_filter_equal():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((32, 4))
    q = tf.constant(q / np.linalg.norm(q, axis=-1, keepdims=True), tf.float32)
    np.testing.assert_array_equal(tox.quat_xyzw_to_euler(q).numpy(), jox.quat_xyzw_to_euler(q).numpy())
    for act in (np.zeros((3, 7), np.float32), rng.standard_normal((3, 7)).astype(np.float32)):
        traj = {"action": tf.constant(act)}
        assert bool(tox.droid_zero_action_filter(traj)) == bool(jox.droid_zero_action_filter(traj))


def _traj():
    return jtt._traj()  # the JAX test's trajectory (numpy seed 0)


def test_traj_transforms_equal():
    assert ttraj.tree_merge({"a": {"x": 1}, "b": 2}, {"a": {"y": 3}}) == \
        jtraj.tree_merge({"a": {"x": 1}, "b": 2}, {"a": {"y": 3}})
    s = tf.constant(["a", "b"])
    np.testing.assert_array_equal(ttraj.to_padding(s).numpy(), jtraj.to_padding(s).numpy())
    assert_equal(plain(ttraj.add_pad_mask_dict(_traj())), plain(jtraj.add_pad_mask_dict(_traj())))
    for fn in ("uniform_goal_relabel", "subsample"):
        args = (3,) if fn == "subsample" else ()
        tf.random.set_seed(11)
        want = plain(getattr(jtraj, fn)(_traj(), *args))
        tf.random.set_seed(11)
        got = plain(getattr(ttraj, fn)(_traj(), *args))
        assert_equal(got, want, fn)


@pytest.mark.parametrize("keep_image_prob", [0.0, 0.5, 1.0])
def test_delete_task_conditioning_equal(keep_image_prob):
    def task_traj(mod):
        # images are still encoded strings at trajectory-transform time
        t = _traj()
        t["task"]["image_primary"] = tf.constant([f"jpeg{i}" for i in range(8)])
        t["task"]["timestep"] = tf.range(8)
        return mod.add_pad_mask_dict(t)

    tf.random.set_seed(3)
    want = plain(jtraj.delete_task_conditioning(task_traj(jtraj), keep_image_prob))
    tf.random.set_seed(3)
    got = plain(ttraj.delete_task_conditioning(task_traj(ttraj), keep_image_prob))
    assert_equal(got, want)
