"""The port's attack CLI and runner on the CPU: a tiny UADA run to the end
with the JAX runner's artifacts, `patch.pt` interchangeable both ways with
the JAX package's artifacts, the resumable state, the refused
options, runs on real-format RLDS data (the tfrecord and
native layers) against the JAX CLI's data setup, and no silent CPU
fallback."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from roboticattack_tpu.attacks.artifacts import load_patch as jload_patch
from roboticattack_tpu.attacks.artifacts import save_patch_pt as jsave_patch_pt
from roboticattack_torch.attacks import artifacts as tart
from roboticattack_torch.attacks.attacker import AttackConfig, OpenVLAAttacker
from roboticattack_torch.attacks.engine import AttackState
from roboticattack_torch.attacks.optimizer import AdamState
from roboticattack_torch.cli import attack as cli
from roboticattack_torch.eval import policy as tpolicy
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.vlm import init_vla_params

TINY = ["--model", "vla-tiny", "--dataset", "dummy", "--iter", "3", "--innerLoop", "2",
        "--bs", "2", "--eval_every", "2", "--eval_batches", "1"]


@pytest.fixture(scope="module")
def uada_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("uada")
    result = cli.main(["--attack", "uada", "--device", "cpu", "--maskidx", "0,1,2,3,4,5,6",
                       "--output", str(out), *TINY])
    return out, result


def test_tiny_cli_run_writes_the_jax_runners_artifacts(uada_run):
    out, result = uada_run
    for tag in ("final", "last", "0"):
        for name in ("patch.pt", "patch.png", "patch.npy"):
            assert (out / tag / name).is_file(), f"{tag}/{name}"
    assert len(list((out / "last" / "val_related_data").glob("*.png"))) == 8
    for name in ("train_CE_loss", "train_inner_avg_loss", "val_ce", "val_mse_distance", "val_uad"):
        with open(out / f"{name}.pkl", "rb") as f:
            values = pickle.load(f)
        assert values and np.all(np.isfinite(values)), name
    lines = [json.loads(ln) for ln in (out / "run-metrics.jsonl").read_text().splitlines()]
    train = [ln for ln in lines if "TRAIN_loss" in ln]
    assert [ln["step"] for ln in train] == [0, 1, 2]
    assert all(np.isfinite(ln["TRAIN_loss"]) for ln in train)
    assert any("VAL_val_mse_distance" in ln for ln in lines)
    assert any("TIMING_p50_s" in ln for ln in lines)
    patch = result.patch
    assert patch.shape == (50, 50, 3) and patch.min() >= 0.0 and patch.max() <= 1.0
    assert sorted(os.listdir(out / "attack_state")) == [
        "latest-checkpoint", "step-000000-epoch-00", "step-000002-epoch-00"]


def test_patch_pt_is_interchangeable_with_the_jax_package(uada_run, tmp_path):
    out, result = uada_run
    np.testing.assert_array_equal(jload_patch(str(out / "final" / "patch.pt")), result.patch)
    theirs = np.random.default_rng(0).uniform(size=(12, 9, 3)).astype(np.float32)
    jsave_patch_pt(theirs, str(tmp_path / "jax.pt"))
    np.testing.assert_array_equal(tart.load_patch(str(tmp_path / "jax.pt")), theirs)
    t = torch.load(out / "final" / "patch.pt", weights_only=True)
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 50, 50)


def test_png_writer_round_trips(tmp_path):
    """The PNG encoder needs no imaging library; PIL reads its files back."""
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    tart.write_png(img, str(tmp_path / "x.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png").convert("RGB")), img)


def test_state_round_trip_and_resume(tmp_path):
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu")
    attack = AttackConfig(objective="tma", maskidx=[6], num_iter=2, inner_loop=1, batch_size=2,
                          eval_every=1, eval_batches=1, patch_size=(3, 8, 8), warmup=0)
    runner = OpenVLAAttacker(params, VLA_TINY, str(tmp_path), attack)
    state = AttackState(patch=torch.rand(8, 8, 3), grad_acc=torch.randn(8, 8, 3),
                        opt=AdamState(torch.randn(8, 8, 3), torch.rand(8, 8, 3), torch.tensor(4, dtype=torch.int32)))
    runner.best = 0.25
    runner.histories = {"val_l1": [0.5, 0.25]}
    path = runner.save_state(state, 7)
    again = OpenVLAAttacker(params, VLA_TINY, str(tmp_path), attack)
    loaded, start = again.load_state(str(tmp_path))
    assert start == 8 and again.best == 0.25 and again.histories == {"val_l1": [0.5, 0.25]}
    for a, b in zip(torch.utils._pytree.tree_leaves(loaded), torch.utils._pytree.tree_leaves(state)):
        assert torch.equal(a, b)
    assert os.path.realpath(tmp_path / "attack_state" / "latest-checkpoint") == path
    assert os.path.basename(path) == "step-000007-epoch-00"


def test_resume_reads_a_run_dir_of_step_files(tmp_path):
    """A run dir whose attack_state/ holds step-<N>.pt files (the layout
    before the checkpoint directories) still resumes from its newest one."""
    params = init_vla_params(torch.Generator().manual_seed(0), VLA_TINY)
    attack = AttackConfig(objective="tma", maskidx=[6], num_iter=2, inner_loop=1, batch_size=2,
                          eval_every=1, eval_batches=1, patch_size=(3, 8, 8), warmup=0)
    state = AttackState(patch=torch.rand(8, 8, 3), grad_acc=torch.randn(8, 8, 3),
                        opt=AdamState(torch.randn(8, 8, 3), torch.rand(8, 8, 3), torch.tensor(4, dtype=torch.int32)))
    (tmp_path / "attack_state").mkdir()
    for step, best in ((3, 0.5), (11, 0.125)):
        torch.save({"patch": state.patch, "m": state.opt.m, "v": state.opt.v, "count": state.opt.count,
                    "grad_acc": state.grad_acc, "_best": best, "_histories": {"val_l1": [best]}},
                   tmp_path / "attack_state" / f"step-{step:06d}.pt")
    runner = OpenVLAAttacker(params, VLA_TINY, str(tmp_path / "out"), attack)
    loaded, start = runner.load_state(str(tmp_path))
    assert start == 12 and runner.best == 0.125 and runner.histories == {"val_l1": [0.125]}
    for a, b in zip(torch.utils._pytree.tree_leaves(loaded), torch.utils._pytree.tree_leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags,match", [
    (["--checkpoint", "/nonexistent"], "/nonexistent"),
    (["--data_parallel", "true", "--ddp_semantics", "exact", "--accumulate", "2"], "accumulate"),
])
def test_unported_options_raise(flags, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default run dir is ./run/...
    argv = ["--device", "cpu", *TINY]
    # a missing checkpoint directory raises FileNotFoundError naming it,
    # and exact DDP refuses accumulation, each before the run dir is made
    # (the data-parallel options and --profile run: tests/test_torch_ddp.py,
    # tests/test_torch_profiling.py)
    error = FileNotFoundError if "--checkpoint" in flags else NotImplementedError
    with pytest.raises(error, match=match):
        cli.main(argv + flags)
    assert not (tmp_path / "run").exists(), "a refused run left a run dir behind"


@pytest.mark.parametrize("layer", ["native", "tfrecord"])
def test_dummy_dataset_ignores_file_layer(tmp_path, layer):
    """--dataset dummy reads no files, so --file_layer does not apply (the
    JAX CLI returns the dummy iterators before it reads it): the run
    completes with the final patch of the same run under the default tf."""
    argv = ["--attack", "tma", "--device", "cpu", "--maskidx", "6", "--iter", "2", "--innerLoop", "1",
            "--model", "vla-tiny", "--dataset", "dummy", "--bs", "2", "--eval_every", "2",
            "--eval_batches", "1"]
    want = cli.main([*argv, "--output", str(tmp_path / "tf")]).patch
    got = cli.main([*argv, "--file_layer", layer, "--output", str(tmp_path / layer)]).patch
    np.testing.assert_array_equal(got, want)


def test_cli_without_device_cpu_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--attack", "uada", "--output", str(tmp_path), *TINY])
    assert not (tmp_path / "final").exists()


# ------------------------------------------------------------------ RLDS data
BRIDGE_STATS = {"action": {"mean": [0.0] * 7, "std": [1.0] * 7, "min": [-3.0] * 7, "max": [3.0] * 7,
                           "q01": [-2.0] * 7, "q99": [2.0] * 7, "mask": [True] * 6 + [False]}}


@pytest.fixture
def layouts(tmp_path, monkeypatch):
    """A 20-episode bridge_orig layout written by each package's writer from
    one seed (each package caches its statistics apart), the home statistics
    caches moved under tmp_path, and a --stats_json file."""
    from roboticattack_tpu.data import rlds as jr
    from roboticattack_tpu.data import synthetic_shards as jss
    from roboticattack_torch.data import rlds as tr
    from roboticattack_torch.data import synthetic_shards as tss

    monkeypatch.setattr(jr, "LOCAL_STATS_CACHE", str(tmp_path / "jax_home_cache"))
    monkeypatch.setattr(tr, "LOCAL_STATS_CACHE", str(tmp_path / "torch_home_cache"))
    dirs = {}
    for pkg, mod in (("jax", jss), ("torch", tss)):
        dirs[pkg] = str(tmp_path / f"data_{pkg}")
        mod.write_rlds_layout(dirs[pkg], n_episodes=20, steps=5, image_size=32,
                              rng=np.random.default_rng(11))
    stats_json = tmp_path / "stats.json"
    stats_json.write_text(json.dumps({"bridge_orig": BRIDGE_STATS}))
    return dirs, str(stats_json)


def jax_make_data(argv, out_dir):
    """What the JAX CLI does with `argv` before its first step: parse, then
    make_data, which writes <out_dir>/dataset_statistics.json."""
    from roboticattack_tpu.cli import attack as jcli
    from roboticattack_tpu.models import get_config

    os.makedirs(out_dir, exist_ok=True)  # the JAX CLI makes its run dir first
    return jcli.make_data(jcli.build_parser().parse_args(argv), get_config("vla-tiny"), out_dir=out_dir)


@pytest.mark.parametrize("flags,error,match", [
    (["--file_layer", "tf"], ImportError, "tensorflow_datasets"),
    (["--file_layer", "native"], ValueError, "needs `stats`"),
])
def test_data_refusals_raise_as_the_jax_cli(flags, error, match, layouts, tmp_path, monkeypatch):
    """--file_layer tf without tensorflow_datasets, and native without
    --stats_json, raise the JAX CLI's error with its message, before the
    port's CLI makes a run dir."""
    dirs, _ = layouts
    argv = ["--model", "vla-tiny", "--dataset", "bridge_orig", "--data_dir", dirs["jax"], *flags]
    with pytest.raises(error, match=match) as want:
        jax_make_data(argv, str(tmp_path / "jax_run"))
    monkeypatch.chdir(tmp_path)
    argv[argv.index("--data_dir") + 1] = dirs["torch"]
    with pytest.raises(error, match=match) as got:
        cli.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value).replace(dirs["jax"], dirs["torch"])
    assert not (tmp_path / "run").exists(), "a refused run left a run dir behind"


@pytest.mark.parametrize("layer", ["tfrecord", "native"])
def test_cli_runs_on_rlds_data(layer, layouts, tmp_path, monkeypatch):
    """`cli.attack --dataset bridge_orig --file_layer tfrecord|native` runs
    the tiny UADA attack on the CPU: finite losses, the DATA_* lines at the
    eval steps, and dataset_statistics.json equal to the one the JAX CLI
    writes for the same layout (computed from the shards on the tfrecord
    layer, --stats_json's on the native one). Without --device cpu it asks
    for CUDA."""
    dirs, stats_json = layouts
    argv = ["--attack", "uada", "--model", "vla-tiny", "--dataset", "bridge_orig", "--file_layer", layer,
            "--iter", "3", "--innerLoop", "2", "--bs", "2", "--eval_every", "2", "--eval_batches", "1",
            "--shuffle_buffer", "32", "--seed", "3"]
    if layer == "native":
        argv += ["--stats_json", stats_json]
    jax_make_data(argv + ["--data_dir", dirs["jax"]], str(tmp_path / "jax_run"))
    out = tmp_path / "run"
    result = cli.main(argv + ["--data_dir", dirs["torch"], "--device", "cpu", "--output", str(out)])
    want = json.loads((tmp_path / "jax_run" / "dataset_statistics.json").read_text())
    got = json.loads((out / "dataset_statistics.json").read_text())
    assert got == want and list(got) == ["bridge_orig"]
    if layer == "native":
        assert got["bridge_orig"] == BRIDGE_STATS
    else:
        assert got["bridge_orig"]["num_trajectories"] == 20
    lines = [json.loads(ln) for ln in (out / "run-metrics.jsonl").read_text().splitlines()]
    losses = [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    data = [ln for ln in lines if "DATA_frames_seen" in ln]
    assert [ln["step"] for ln in data] == [0, 2]
    for ln in data:
        assert ln["DATA_frames_seen"] >= 2 and ln["DATA_frames_skipped_pad_to"] == 0
        assert ln["DATA_pad_to_skip_rate"] == 0.0
    assert sum("VAL_val_mse_distance" in ln for ln in lines) == 2
    patch = result.patch
    assert patch.shape == (50, 50, 3) and 0.0 <= patch.min() and patch.max() <= 1.0

    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["--data_dir", dirs["torch"], "--output", str(tmp_path / "no_cuda")])
    assert not (tmp_path / "no_cuda").exists()
