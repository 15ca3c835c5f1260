"""The port's serving surface on the CPU: VLAPolicy against the JAX
VLAPolicy (weights shared through the bridge), DynamicBatcher coalescing and
bucket padding, one HTTP round trip, and the port's guards (no JAX imports,
no silent CPU fallback, unported options refused)."""

import ast
import base64
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import jax
import pytest

from roboticattack_tpu.eval.policy import VLAPolicy as JaxPolicy
from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.eval import policy as tpolicy
from roboticattack_torch.eval.policy import VLAPolicy, load_policy
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from roboticattack_torch.ops.q4_matmul import q4_matmul, reset_launches
from roboticattack_torch.serving import ActionServer, DynamicBatcher, default_buckets
from roboticattack_torch.utils.prompting import WordStubTokenizer

REPO = Path(__file__).resolve().parents[1]
STATS = {"k": {"action": {"q01": [-0.2] * 7, "q99": [0.4] * 7, "mask": [True] * 6 + [False]}}}
TASKS = ["pick up the block", "close the drawer", "open the top drawer"]


def _frames(n, seed=0, size=56):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_vla_params(jax.random.key(11), VLA_TINY))


@pytest.fixture(scope="module")
def tiny_policy():
    return load_policy(None, "vla-tiny", device="cpu")


# ------------------------------------------------------------------ policy
@pytest.mark.parametrize("quantize", [None, "int4"])
def test_get_action_multi_matches_jax_policy(jax_params, quantize):
    """Same weights, frames and instructions: the port's VLAPolicy returns
    the JAX VLAPolicy's tokens and unnormalized actions (int4: JAX runs its
    Pallas kernel interpreted, the port the kernel's plain version)."""
    frames = _frames(3, seed=1)
    kw = dict(quantize=quantize, int4_kernel=quantize == "int4")
    want_pol = JaxPolicy(jax_params, VLA_TINY, JaxStub(), STATS, **kw)
    got_pol = VLAPolicy(params_from_jax(jax_params, "cpu", T_TINY), T_TINY,
                        WordStubTokenizer(), STATS, device="cpu", **kw)
    want = want_pol.get_action_multi(frames, TASKS)
    got = got_pol.get_action_multi(frames, TASKS)
    np.testing.assert_array_equal(got_pol.last_tokens, want_pol.last_tokens)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.shape == (3, 7)


def test_word_stub_tokenizer_matches_jax():
    text = "In: What action should the robot take to pick up the block?\nOut:"
    assert WordStubTokenizer().encode(text) == JaxStub().encode(text)


def test_get_action_multi_rows_are_independent(tiny_policy):
    frames = _frames(2, seed=2)
    mixed = tiny_policy.get_action_multi(frames, TASKS[:2])
    same_a = tiny_policy.get_action_batch(frames, TASKS[0])
    np.testing.assert_array_equal(mixed[0], same_a[0])
    np.testing.assert_array_equal(tiny_policy.get_action(frames[1], TASKS[1]), mixed[1])
    with pytest.raises(ValueError, match="task labels"):
        tiny_policy.get_action_multi(frames, TASKS[:1])


# ------------------------------------------------------------------ guards
def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No file of the port, nor chip_smoke.py, imports jax or the JAX
    package (an AST scan, so lazy imports inside functions count too)."""
    files = sorted((REPO / "roboticattack_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{f.relative_to(REPO)}: {mod}"
        for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "roboticattack_tpu")
    ]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch, jax_params):
    """Without a GPU, the default device (cuda) raises; only an explicit
    device='cpu' runs on the CPU."""
    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_policy(None, "vla-tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VLAPolicy(params_from_jax(jax_params, "cpu", T_TINY), T_TINY,
                  WordStubTokenizer(), STATS)
    pol = load_policy(None, "vla-tiny", device="cpu")
    assert pol.device.type == "cpu" and not pol.int4_kernel


def test_int4_kernel_on_cuda_refuses_a_float32_model(monkeypatch, jax_params):
    """The CUDA kernel takes bf16 activations: an f32 model (vla-tiny) with
    the kernel on, explicitly or by the CUDA default, is refused before any
    weight moves, not run some other way."""
    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: True)
    for kernel in (None, True):
        with pytest.raises(ValueError, match="int4_kernel=False"):
            VLAPolicy(params_from_jax(jax_params, "cpu", T_TINY), T_TINY,
                      WordStubTokenizer(), STATS, quantize="int4",
                      int4_kernel=kernel, device="cuda")


def test_int4_kernel_on_cuda_refuses_a_group_the_kernel_cannot_take(monkeypatch, jax_params):
    """The CUDA kernel takes groups of 32 * 2^k channels (k <= 5): a bf16
    model quantized with groups of 16 and the kernel on, explicitly or by the
    CUDA default, is refused at construction, before any weight moves (not
    at the first tail launch, after the prefill). The model's own group, 64,
    passes the same check and constructs."""
    bf16 = dataclasses.replace(T_TINY, dtype="bfloat16")
    moved = []

    def to_device(tree, device):  # keeps the weights on the CPU, records the move
        moved.append(device)
        return tree

    monkeypatch.setattr(tpolicy.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tpolicy, "_to_device", to_device)
    for kernel in (None, True):
        with pytest.raises(ValueError, match="int4_kernel=False"):
            VLAPolicy(params_from_jax(jax_params, "cpu", bf16), bf16, WordStubTokenizer(), STATS,
                      quantize="int4:16", int4_kernel=kernel, device="cuda")
    assert moved == []
    for quantize in ("int4", "int4:64"):
        pol = VLAPolicy(params_from_jax(jax_params, "cpu", bf16), bf16, WordStubTokenizer(), STATS,
                        quantize=quantize, device="cuda")
        assert pol.int4_kernel and pol.device.type == "cuda"
    assert len(moved) == 2
    pol = VLAPolicy(params_from_jax(jax_params, "cpu", bf16), bf16, WordStubTokenizer(), STATS,
                    quantize="int4:64", int4_kernel=True, device="cpu")
    assert pol.int4_kernel


def test_cpu_int4_policy_launches_no_kernel():
    """int4 on the CPU: auto leaves the kernel off; forcing it on routes
    through the wrapper, which takes the plain version — no launches."""
    reset_launches()
    assert not load_policy(None, "vla-tiny", quantize="int4", device="cpu").int4_kernel
    pol = load_policy(None, "vla-tiny", quantize="int4", int4_kernel=True, device="cpu")
    acts = pol.get_action_batch(_frames(2, seed=3), TASKS[0])
    assert acts.shape == (2, 7) and np.all(np.isfinite(acts))
    assert q4_matmul.launches == {"grouped": 0, "dense": 0}


@pytest.mark.parametrize("kwargs", [
    {"checkpoint": "/nonexistent"}, {"kv_cache": "int8"}, {"visual_tokens": 4},
    {"quantize": "w8a8"}, {"center_crop": True},
])
def test_load_policy_refuses_unported_options(kwargs):
    kwargs = dict(kwargs)
    ckpt = kwargs.pop("checkpoint", None)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_policy(ckpt, "vla-tiny", device="cpu", **kwargs)


def test_serve_cli_refuses_unported_flags():
    from roboticattack_torch.cli.serve import build_parser, main

    args = build_parser().parse_args([])
    assert (args.device, args.int4_kernel, args.model) == ("cuda", "auto", "openvla-7b")
    for flags in (["--tp", "2"], ["--dp", "2"], ["--drafts"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            main(flags + ["--model", "vla-tiny", "--device", "cpu"])


# ------------------------------------------------------------------ batcher
class StubPolicy:
    """Records batch shapes; returns row-indexed actions so tests can check
    request->result mapping through padding."""

    def __init__(self, delay_s=0.0):
        self.calls = []
        self.delay_s = delay_s

    def get_action_multi(self, images, tasks):
        self.calls.append(len(images))
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.stack([np.full(7, float(t.split("#")[-1])) for t in tasks])


def test_default_buckets():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    with pytest.raises(ValueError):
        default_buckets(0)


def test_batcher_coalesces_pads_and_maps_results():
    stub = StubPolicy(delay_s=0.05)
    with DynamicBatcher(stub, max_batch=8, max_wait_ms=300.0) as b:
        futs = [b.submit(_frames(1)[0], f"task#{i}") for i in range(3)]
        out = [f.result(timeout=30) for f in futs]
    for i, r in enumerate(out):
        np.testing.assert_array_equal(r, np.full(7, float(i)))
    assert set(stub.calls) <= {1, 2, 4, 8} and sum(stub.calls) >= 3
    if stub.calls == [4]:  # all three soaked into one window (the common case)
        assert b.stats["padded_rows"] == 1 and b.bucket_counts()[4] == 1
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_frames(1)[0], "task#9")


def test_batcher_refuses_drafts():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DynamicBatcher(StubPolicy(), drafts=True)


# --------------------------------------------------------------------- http
def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip_tiny_policy(tiny_policy):
    """Concurrent POST /act against the torch tiny policy on the CPU: every
    caller gets 7 finite actions; malformed and drafted bodies get a 400."""
    frames = _frames(3, seed=4)
    with ActionServer(tiny_policy, max_batch=4, max_wait_ms=100.0) as srv:
        host, port = srv.address
        url = f"http://{host}:{port}"
        replies = {}

        def client(i):
            replies[i] = _post(url + "/act", {
                "task": TASKS[i], "shape": list(frames[i].shape),
                "image_b64": base64.b64encode(frames[i].tobytes()).decode(),
            })

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        bad = _post(url + "/act", {"task": "x", "image": [[1, 2]]})
        drafted = _post(url + "/act", {"task": "x", "image": frames[0].tolist(),
                                       "draft_tokens": [0] * 7})
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    for i in range(3):
        code, body = replies[i]
        assert code == 200
        a = np.asarray(body["action"])
        assert a.shape == (7,) and np.all(np.isfinite(a))
    assert bad[0] == 400 and drafted[0] == 400
    assert health["ok"] and health["stats"]["requests"] == 3
