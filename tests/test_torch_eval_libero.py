"""Slice 5 of the port on the CPU: the closed-loop LIBERO evaluation
(`eval/libero.py`), the eval queue, the WidowX driver and the three eval CLIs,
each against the JAX package's on the same inputs.

LIBERO, robosuite and widowx_envs are not installed: chip_smoke's replay
`libero` package (after tests/test_libero_loop.py) serves recorded 256x256
frames and succeeds after a fixed count of real steps; a fake WidowX client
serves frames and proprio states. Both packages run the same episodes with the same weights
(`models/bridge.py:params_from_jax`).

Tolerances: the action logs equal to 1e-12 absolute (the tokens are equal; the
unnormalized actions are float64 from the same bins, as
test_torch_serving.py's policy test holds them), log and summary files
byte-equal, frames at resize_size=256 bit-equal (the JPEG round trip and the
lanczos3 transcription equal TensorFlow's bit for bit there)."""

import json
import os
import sys
import types

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from roboticattack_tpu.attacks.artifacts import save_patch_pt as jax_save_patch_pt
from roboticattack_tpu.eval import bridge as jbridge
from roboticattack_tpu.eval import libero as jlibero
from roboticattack_tpu.eval import queue as jqueue
from roboticattack_tpu.eval.policy import VLAPolicy as JaxPolicy
from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.eval import bridge as tbridge
from roboticattack_torch.eval import libero as tlibero
from roboticattack_torch.eval import queue as tqueue
from roboticattack_torch.eval.policy import VLAPolicy
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.utils.prompting import WordStubTokenizer

STATS = {"k": {"action": {"q01": [-0.2] * 7, "q99": [0.4] * 7, "mask": [True] * 6 + [False]}}}
REAL_STEPS = 4  # post-settle steps after which a replay episode succeeds
DUMMY = [0, 0, 0, 0, 0, 0, -1]


def coherent_frames(seed, n=24):
    """Recorded frames as a bounded random walk (chip_smoke.coherent_walk)."""
    return chip_smoke.coherent_walk(np.random.default_rng(seed), n)


def install_fake_libero(monkeypatch, frames, never_done=False):
    """chip_smoke's replay `libero` in sys.modules: two initial states that
    serve `frames` (a third trial takes the first again, as in LIBERO),
    success after REAL_STEPS real steps unless `never_done`."""
    replay = chip_smoke.ReplayLibero([frames, frames], None if never_done else REAL_STEPS,
                                     suite="libero_spatial")
    for name, mod in replay.mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return replay


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_vla_params(jax.random.key(17), VLA_TINY))


@pytest.fixture(scope="module")
def policies(jax_params):
    """The JAX and the port's VLA_TINY policies on the same weights."""
    return (JaxPolicy(jax_params, VLA_TINY, JaxStub(), STATS),
            VLAPolicy(params_from_jax(jax_params, "cpu", T_TINY), T_TINY, WordStubTokenizer(), STATS,
                      device="cpu"))


@pytest.fixture()
def patch_path(tmp_path):
    patch = np.random.default_rng(6).uniform(0, 1, (20, 20, 3)).astype(np.float32)
    path = str(tmp_path / "patch.pt")
    jax_save_patch_pt(patch, path)
    return path


def run_both(replay, policies, tmp_path, patch_path, **kw):
    """eval_libero of each package over the same replay episodes: per
    package (successes, episodes, action log, {file name: bytes})."""
    out = {}
    for tag, mod, policy in (("jax", jlibero, policies[0]), ("torch", tlibero, policies[1])):
        policy.last_tokens = None
        d = tmp_path / tag
        cfg = mod.LiberoEvalConfig(task_suite_name="libero_spatial", patchroot=patch_path, x=120, y=160,
                                   resize_size=256, output_dir=str(d), **kw)
        replay.actions = []
        successes, episodes = mod.eval_libero(cfg, policy)
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
        out[tag] = (successes, episodes, [a.copy() for a in replay.actions], files)
    return out["jax"], out["torch"]


@pytest.mark.parametrize("kw", [
    dict(num_trials_per_task=2),
    dict(num_trials_per_task=3, batch_trials=2),
    dict(num_trials_per_task=2, jacobi=True),
    dict(num_trials_per_task=3, batch_trials=2, jacobi=True),
], ids=["sequential", "lockstep", "jacobi", "lockstep-jacobi"])
def test_eval_libero_equals_jax(monkeypatch, tmp_path, policies, patch_path, kw):
    """Sequential and lockstep (3 trials at width 2: the last group padded)
    runs, with and without Jacobi drafts: the same action log (settle steps,
    gripper chain), the same accounting, and byte-equal episode logs and
    `<suite>.txt` summaries."""
    replay = install_fake_libero(monkeypatch, coherent_frames(41))
    want, got = run_both(replay, policies, tmp_path, patch_path, **kw)
    n = kw["num_trials_per_task"]
    assert got[:2] == want[:2] == (n, n)
    assert len(got[2]) == len(want[2]) == n * (10 + REAL_STEPS)
    np.testing.assert_allclose(np.stack(got[2]), np.stack(want[2]), rtol=0, atol=1e-12)
    assert got[3] == want[3]
    assert set(got[3]) == {"EVAL-libero_spatial--120_160_0_0_0.txt", "libero_spatial.txt"}
    assert got[3]["libero_spatial.txt"] == (
        f"success_rate/total:1.0, num_episodes/total:{n} position_info:0.0_0.0_0.0_120_160 \n").encode()


def test_failed_episode_runs_to_max_steps_as_jax(monkeypatch, tmp_path, policies, patch_path):
    """A never-succeeding episode stops at the suite's patched budget plus
    the settle steps, in both packages, with equal logs (the budget cut to
    9 steps in both: the loop is the same at the suite's 193)."""
    replay = install_fake_libero(monkeypatch, coherent_frames(43, n=8), never_done=True)
    for mod in (jlibero, tlibero):
        monkeypatch.setitem(mod.MAX_STEPS_PATCHED, "libero_spatial", 9)
    want, got = run_both(replay, policies, tmp_path, patch_path, num_trials_per_task=1)
    assert got[:2] == want[:2] == (0, 1)
    assert len(got[2]) == 9 + tlibero.NUM_SETTLE_STEPS
    np.testing.assert_allclose(np.stack(got[2]), np.stack(want[2]), rtol=0, atol=1e-12)
    assert got[3] == want[3]


def test_frames_reaching_the_policy(monkeypatch, tmp_path, policies, patch_path):
    """What the port's policy sees is apply_patch_to_frame(libero_frame(obs))
    of the JAX package, bit for bit, at the placement of the queue."""
    frames = coherent_frames(44)
    replay = install_fake_libero(monkeypatch, frames)
    seen = {"jax": [], "torch": []}
    for tag, policy in zip(seen, policies):
        orig = policy.get_action

        def rec(frame, task, _orig=orig, _seen=seen[tag], **k):
            _seen.append(frame.copy())
            return _orig(frame, task, **k)

        monkeypatch.setattr(policy, "get_action", rec)
    run_both(replay, policies, tmp_path, patch_path, num_trials_per_task=1)
    assert len(seen["torch"]) == len(seen["jax"]) == REAL_STEPS
    cfg = jlibero.LiberoEvalConfig(x=120, y=160)
    patch = jlibero.load_patch(patch_path)
    for i, (g, w) in enumerate(zip(seen["torch"], seen["jax"])):
        np.testing.assert_array_equal(g, w)
        want = jlibero.apply_patch_to_frame(jlibero.libero_frame(frames[10 + i], 224), patch, cfg)
        got = tlibero.apply_patch_to_frame(tlibero.libero_frame(frames[10 + i], 224), patch, cfg)
        np.testing.assert_array_equal(got, want)


def test_protocol_constants_equal_jax():
    assert tlibero.MAX_STEPS_PATCHED == jlibero.MAX_STEPS_PATCHED
    assert tlibero.MAX_STEPS_CLEAN == jlibero.MAX_STEPS_CLEAN
    assert tlibero.NUM_SETTLE_STEPS == jlibero.NUM_SETTLE_STEPS == 10
    assert tlibero.DUMMY_ACTION == jlibero.DUMMY_ACTION == DUMMY
    assert tqueue.SUITE_PLACEMENTS == jqueue.SUITE_PLACEMENTS
    assert tqueue.COMPLETE_SENTINEL == jqueue.COMPLETE_SENTINEL
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(tlibero.LiberoEvalConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jlibero.LiberoEvalConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(tbridge.BridgeEvalConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jbridge.BridgeEvalConfig)]


def test_eval_libero_without_libero_raises_as_jax(monkeypatch, policies):
    for name in ("libero", "libero.libero", "libero.libero.benchmark", "libero.libero.envs"):
        monkeypatch.setitem(sys.modules, name, None)
    for mod, policy in ((jlibero, policies[0]), (tlibero, policies[1])):
        with pytest.raises(ImportError, match="LIBERO benchmark"):
            mod.eval_libero(mod.LiberoEvalConfig(), policy)


# ------------------------------------------------------------------ queue
@pytest.mark.parametrize("geometry", [{}, {"angle": 15}, {"shx": 2, "shy": 1}])
def test_queue_markers_and_resume_equal_jax(tmp_path, geometry):
    patches = {s: f"/fake/{s}/patch.pt" for s in tqueue.SUITE_PLACEMENTS}
    out = {}
    for tag, mod in (("jax", jqueue), ("torch", tqueue)):
        d = tmp_path / tag
        d.mkdir()
        first = mod.organize_experiments(patches, str(d), **geometry)
        marker = first[1]["marker"]
        with open(marker, "w") as f:  # a partial log: retried
            f.write("task=0 ep=0 success=True running=1/1\n")
        second = mod.organize_experiments(patches, str(d), **geometry)
        with open(marker, "a") as f:  # stamped complete: skipped
            f.write(mod.COMPLETE_SENTINEL + "\n")
        third = mod.organize_experiments(patches, str(d), **geometry)
        out[tag] = [[{k: (os.path.basename(v) if k == "marker" else v) for k, v in t.items()} for t in r]
                    for r in (first, second, third)]
    assert out["torch"] == out["jax"]
    assert [len(r) for r in out["torch"]] == [4, 4, 3]


def test_run_task_launches_the_port_cli(tmp_path, monkeypatch):
    """The one intended difference: run_task's command names
    roboticattack_torch.cli.eval_libero where JAX's names its own; the rest
    of the command and the completion stamp are the JAX package's."""
    cmds = []
    task = dict(suite="libero_goal", patch="p.pt", x=15, y=158, angle=0, shx=0, shy=0,
                marker=str(tmp_path / "m.txt"))
    for mod in (jqueue, tqueue):
        monkeypatch.setattr(mod.subprocess, "call", lambda cmd: cmds.append(cmd) or 0)
        assert mod.run_task(dict(task), str(tmp_path), "/ckpt", 3, ["--device", "cpu"]) == 0
    want, got = cmds
    assert want[2] == "roboticattack_tpu.cli.eval_libero"
    assert got[2] == "roboticattack_torch.cli.eval_libero"
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert (tmp_path / "m.txt").read_text() == (tqueue.COMPLETE_SENTINEL + "\n") * 2


def test_eval_queue_cli_passes_through(tmp_path, monkeypatch):
    from roboticattack_torch.cli import eval_queue

    seen = {}
    monkeypatch.setattr(tqueue, "run_queue", lambda patches, out, **kw: seen.update(patches=patches, **kw) or {})
    eval_queue.main(["--patch", "p.pt", "--output", str(tmp_path), "--num_trials", "2", "--angle", "5",
                     "--device", "cpu"])
    assert seen["patches"] == {s: "p.pt" for s in tqueue.SUITE_PLACEMENTS}
    assert (seen["angle"], seen["num_trials"], seen["extra_args"]) == (5, 2, ["--device", "cpu"])
    eval_queue.main(["--patch_root", "run/uada", "--output", str(tmp_path)])
    assert seen["patches"] == {s: os.path.join("run/uada", s, "patch.pt") for s in tqueue.SUITE_PLACEMENTS}
    with pytest.raises(SystemExit, match="--patch"):
        eval_queue.main(["--output", str(tmp_path)])


# ------------------------------------------------------------------ bridge
class FakeWidowX:
    """A WidowX client: seeded frames, a proprio state that moves with each
    action (as the robot's does)."""

    def __init__(self, host=None, port=None):
        self.rng, self.state = np.random.default_rng(5), np.zeros(7)

    def init(self, params):
        self.params = params

    def reset(self):
        self.state = np.arange(7, dtype=np.float64) / 10

    def get_observation(self):
        return {"image": self.rng.integers(0, 256, (80, 96, 3), dtype=np.uint8), "state": self.state.copy()}

    def step_action(self, action, blocking=False):
        self.state = self.state + np.asarray(action)[:7]


def test_bridge_rollout_npz_equals_jax_but_states(monkeypatch, tmp_path, policies):
    """The rollout record equals the JAX driver's in every array but
    `states`: JAX reads obs.get("state", zeros) from an observation whose key
    is `proprio` (all zeros); the port records `proprio` (ROADMAP C3)."""
    pkg, svc = types.ModuleType("widowx_envs"), types.ModuleType("widowx_envs.widowx_env_service")
    svc.WidowXClient = FakeWidowX
    svc.WidowXConfigs = types.SimpleNamespace(DefaultEnvParams={"camera_topics": []})
    pkg.widowx_env_service = svc
    monkeypatch.setitem(sys.modules, "widowx_envs", pkg)
    monkeypatch.setitem(sys.modules, "widowx_envs.widowx_env_service", svc)
    answers = iter(["", "y", "", "n"] * 2)
    monkeypatch.setattr("builtins.input", lambda *a: next(answers))
    monkeypatch.setattr(tbridge.time, "sleep", lambda s: None)
    monkeypatch.setattr(jbridge.time, "sleep", lambda s: None)
    records = {}
    for tag, mod, policy in (("jax", jbridge, policies[0]), ("torch", tbridge, policies[1])):
        cfg = mod.BridgeEvalConfig(max_episodes=3, max_steps=3, resize_size=56, save_dir=str(tmp_path / tag))
        mod.run_bridge_eval(cfg, policy, "put the spoon in the pot")
        records[tag] = [dict(np.load(tmp_path / tag / f"rollout-{i}.npz")) for i in (1, 2)]
        assert not (tmp_path / tag / "rollout-3.npz").exists()  # "n" ended the run
    for got, want in zip(records["torch"], records["jax"]):
        assert set(got) == set(want) == {"orig_images", "images", "states", "actions"}
        for k in ("orig_images", "images"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["actions"], want["actions"], rtol=0, atol=1e-12)
        # the one intended difference: the proprio fix
        assert not want["states"].any()
        replay = np.arange(7) / 10 + np.concatenate([np.zeros((1, 7)), np.cumsum(got["actions"], 0)[:-1]])
        np.testing.assert_allclose(got["states"], replay, rtol=0, atol=1e-12)


# ------------------------------------------------------------------ CLIs
def test_eval_libero_cli_on_the_cpu(monkeypatch, tmp_path, patch_path, capsys):
    """`cli.eval_libero --device cpu` end to end on vla-tiny's random
    weights over the replay env, with a config file folded in under the
    flags; without --device it asks for CUDA."""
    from roboticattack_torch.cli import eval_libero
    from roboticattack_torch.eval import policy as tpolicy
    from roboticattack_torch.utils.configurate import dump_config

    install_fake_libero(monkeypatch, coherent_frames(45))
    cfg_path = str(tmp_path / "eval.yaml")
    dump_config(tlibero.LiberoEvalConfig(num_trials_per_task=3, x=7, y=9, output_dir=str(tmp_path / "cfg")),
                cfg_path)
    argv = ["--model", "vla-tiny", "--patchroot", patch_path, "--config_path", cfg_path, "--x", "120",
            "--batch_trials", "2", "--jacobi", "true", "--quantize", "int4", "--int4_kernel", "on"]
    eval_libero.main(argv + ["--device", "cpu"])
    assert "success rate: 3/3" in capsys.readouterr().out
    assert (tmp_path / "cfg" / "EVAL-libero_spatial--120_9_0_0_0.txt").exists()
    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_libero.main(argv)
    for flags in (["--tp", "2"], ["--dp", "2"]):  # a world of one process
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            eval_libero.main(argv + flags + ["--device", "cpu"])


def test_eval_cli_parsers_match_jax():
    """Every flag of the JAX CLIs, with its default; the port adds --device
    (default cuda)."""
    from roboticattack_tpu.cli import eval_bridge as jb
    from roboticattack_tpu.cli import eval_libero as jl
    from roboticattack_torch.cli import eval_bridge as tb
    from roboticattack_torch.cli import eval_libero as tl

    for j, t in ((jl, tl), (jb, tb)):
        want = {a.dest: a.default for a in j.build_parser()._actions}
        got = {a.dest: a.default for a in t.build_parser()._actions}
        assert got.pop("device") == "cuda"
        assert got == want


def test_eval_bridge_cli_config_file(tmp_path):
    from roboticattack_tpu.cli import eval_bridge as jb
    from roboticattack_torch.cli import eval_bridge as tb
    from roboticattack_torch.utils.configurate import dump_config

    path = str(tmp_path / "bridge.json")
    dump_config(tbridge.BridgeEvalConfig(port=6000, initial_eep=(0.1, 0.2, 0.3), jacobi=True), path)
    cfgs = []
    for mod in (jb, tb):
        parser = mod.build_parser()
        mod.apply_config_file(parser, ["--config_path", path, "--max_steps", "9"])
        cfgs.append(mod.config_from_args(parser.parse_args(["--config_path", path, "--max_steps", "9"])))
    assert cfgs[1].__dict__ == cfgs[0].__dict__
    assert (cfgs[1].port, cfgs[1].initial_eep, cfgs[1].max_steps, cfgs[1].jacobi) == (6000, (0.1, 0.2, 0.3), 9, True)


@pytest.mark.parametrize("cls", ["LiberoEvalConfig", "BridgeEvalConfig"])
@pytest.mark.parametrize("ext", ["yaml", "json"])
def test_configurate_round_trips_eval_configs_as_jax(tmp_path, cls, ext):
    """dump_config writes the JAX package's bytes for the same config, and
    load_config reads them back to an equal config."""
    from roboticattack_tpu.utils import configurate as jconf
    from roboticattack_torch.utils import configurate as tconf

    tmod, jmod = (tlibero, jlibero) if cls == "LiberoEvalConfig" else (tbridge, jbridge)
    kw = ({"task_suite_name": "libero_goal", "x": 15, "y": 158, "angle": 2.5, "batch_trials": 8}
          if cls == "LiberoEvalConfig" else {"host_ip": "10.0.0.2", "initial_eep": (0.3, 0.1, 0.2)})
    tcfg, jcfg = getattr(tmod, cls)(**kw), getattr(jmod, cls)(**kw)
    tconf.dump_config(tcfg, str(tmp_path / f"t.{ext}"))
    jconf.dump_config(jcfg, str(tmp_path / f"j.{ext}"))
    assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    back = tconf.load_config(getattr(tmod, cls), str(tmp_path / f"j.{ext}"))
    assert back == tcfg
    assert json.dumps(tconf.config_to_dict(back), default=str) == json.dumps(jconf.config_to_dict(jcfg), default=str)


# ------------------------------------------------------------------ chip_smoke rehearsal
def rehearse_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's setting for a CPU rehearsal of its eval and verify
    phases: a bf16-free tiny model with flash attention and remat registered
    as chip_smoke.MODEL, its checkpoint written by the port's exporter,
    DEVICE "cpu", the torch.cuda calls stubbed, and the plain versions of
    B1/B2 and the int4 tail counted as the kernels' launches would be (they
    launch nothing on the CPU). Returns the checkpoint directory."""
    import dataclasses

    import chip_smoke
    import torch
    from roboticattack_torch.cli import eval_libero
    from roboticattack_torch.models import decode
    from roboticattack_torch.models.config import REGISTRY
    from roboticattack_torch.models.vlm import init_vla_params
    from roboticattack_torch.ops import flash_attention as fa
    from roboticattack_torch.ops import q4_matmul as q4

    tiny = dataclasses.replace(T_TINY, name="vla-tiny-flash-remat", remat=True,
                               llm=dataclasses.replace(T_TINY.llm, attn_impl="flash"))
    monkeypatch.setitem(REGISTRY, tiny.name, tiny)
    monkeypatch.setattr(chip_smoke, "MODEL", tiny.name)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    for kind in ("fwd", "bwd"):
        plain = getattr(fa, f"flash_attention_{kind}_plain")

        def counted(*a, _plain=plain, _kind=kind, **k):
            fa.flash_attention.launches[_kind] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(fa, f"flash_attention_{kind}_plain", counted)

    def q4_counted(*a, _real=decode.q4_matmul, **k):
        q4.q4_matmul.launches["grouped"] += 1
        return _real(*a, **k)

    monkeypatch.setattr(decode, "q4_matmul", q4_counted)
    monkeypatch.setattr(eval_libero, "resolve_int4_kernel", lambda s: True)  # the CPU's auto is off
    for name, value in (("synchronize", None), ("reset_peak_memory_stats", None), ("max_memory_allocated", 0),
                        ("empty_cache", None)):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _v=value, **k: _v)
    root = tmp_path / "ckpt"
    root.mkdir()
    chip_smoke.export_checkpoint(init_vla_params(torch.Generator().manual_seed(0), tiny), tiny, str(root),
                                 tiny.name, chip_smoke.CKPT_STATS)
    return str(root)


def test_chip_smoke_eval_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.phase_eval rehearsed on vla-tiny: the three CLI runs over
    the script's replay `libero`, every check of the phase (summary line and
    log name, frames recomputed, B4 counted on every step, Jacobi against the
    sequential tokens), and sys.modules left without a `libero`."""
    import chip_smoke

    root = rehearse_on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, "EVAL_TRIALS", 3)  # 3 trials lockstep at width 3, 4 steps each
    monkeypatch.setattr(chip_smoke, "EVAL_REAL_STEPS", 4)
    out = chip_smoke.phase_eval("CPU", root)
    layers = T_TINY.llm.num_layers
    runs = out["runs"]
    assert set(runs) == {"jacobi", "sequential", "bs 1"}
    for label, run in runs.items():
        assert run["steps"] == chip_smoke.EVAL_REAL_STEPS
        assert run["host_ms"] > 0 and run["policy_ms"] > 0
    assert runs["sequential"]["b4"] == {"grouped": chip_smoke.EVAL_REAL_STEPS * 6 * layers * 7, "dense": 0}
    assert sum(p * n for p, n in runs["jacobi"]["passes"].items()) * layers * 7 == runs["jacobi"]["b4"]["grouped"]
    assert out["excused"] == 0  # on the CPU the kernel's tail is its plain version: no drift
    assert "libero" not in sys.modules
