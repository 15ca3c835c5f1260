"""The port's attack CLI and runner on the CPU: a tiny UADA run to the end
with the JAX runner's artifacts, `patch.pt` interchangeable both ways with
the JAX package's artifacts, the resumable state, the refused
(not yet ported) options, and no silent CPU fallback."""

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
    assert sorted(os.listdir(out / "attack_state")) == ["step-000000.pt", "step-000002.pt"]


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
    runner.save_state(state, 7)
    again = OpenVLAAttacker(params, VLA_TINY, str(tmp_path), attack)
    loaded, start = again.load_state(str(tmp_path))
    assert start == 8 and again.best == 0.25 and again.histories == {"val_l1": [0.5, 0.25]}
    for a, b in zip(torch.utils._pytree.tree_leaves(loaded), torch.utils._pytree.tree_leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags,match", [
    (["--checkpoint", "/nonexistent"], "checkpoint"),
    (["--dataset", "bridge_orig"], "RLDS"),
    (["--dataset", "bridge_orig", "--file_layer", "native"], "RLDS"),
    (["--data_parallel", "true"], "data-parallel"),
    (["--ddp_semantics", "exact"], "data-parallel"),
    (["--profile", "/tmp/trace"], "profile"),
])
def test_unported_options_raise(flags, match):
    argv = ["--device", "cpu", *TINY]
    if "--dataset" in flags:
        argv[argv.index("--dataset") + 1] = flags[1]
        flags = flags[2:]
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + flags)


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
