"""The port's serving surface on the CPU: VLAPolicy against the JAX
VLAPolicy (weights shared through the bridge), with the serving options
(KV cache, visual tokens, w8a8, Jacobi drafts); DynamicBatcher coalescing,
bucket padding and drafts mode; the HTTP protocol with and without drafts;
the serving CLI; and the port's guards (no JAX imports, no silent CPU
fallback, unported options refused)."""

import ast
import base64
import dataclasses
import json
import os
import re
import subprocess
import sys
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
    {"checkpoint": "/nonexistent"}, {"center_crop": True},
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
    for flags in (["--tp", "2"], ["--dp", "2"]):
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


class DraftStubPolicy(StubPolicy):
    """Records the tasks and drafts of each batch."""

    vocab_size = 32064

    def __init__(self):
        super().__init__()
        self.batches = []

    def get_action_multi(self, images, tasks, draft_tokens=None):
        self.batches.append((list(tasks), None if draft_tokens is None else np.array(draft_tokens)))
        return super().get_action_multi(images, tasks)


def test_batcher_drafts_zero_fill_and_pad_with_row0():
    """Drafts mode: warmup runs the Jacobi path with zero drafts at every
    bucket; in a batch a row without a draft gets zeros and a pad row copies
    row 0 (its task and its draft); submit() keeps giving the bare action."""
    stub = DraftStubPolicy()
    with DynamicBatcher(stub, max_batch=4, max_wait_ms=300.0, drafts=True) as b:
        b.warmup(_frames(1)[0], "warmup#0")
        assert [d.shape for _, d in stub.batches] == [(1, 7), (2, 7), (4, 7)]
        assert not any(d.any() for _, d in stub.batches)
        stub.batches.clear()
        futs = [b.submit_full(_frames(1)[0], "task#0", draft_tokens=np.full(7, 5)),
                b.submit(_frames(1)[0], "task#1"),
                b.submit_full(_frames(1)[0], "task#2")]
        out = [f.result(timeout=30) for f in futs]
    assert out[0].tokens is None and out[0].action[0] == 0.0  # StubPolicy has no tokens
    np.testing.assert_array_equal(out[1], np.full(7, 1.0))
    np.testing.assert_array_equal(out[2].action, np.full(7, 2.0))
    for tasks, drafts in stub.batches:
        assert drafts.shape == (len(tasks), 7) and len(tasks) in b.buckets
        for task, row in zip(tasks, drafts):
            np.testing.assert_array_equal(row, np.full(7, 5 if task == "task#0" else 0))


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


def test_submit_full_draft_needs_drafts_mode():
    """A draft sent to a batcher without drafts mode fails at submit time;
    a draft that is not 7 ids too; a draftless submit_full resolves to an
    ActResult."""
    b = DynamicBatcher(StubPolicy(), max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="drafts=True"):
            b.submit_full(_frames(1)[0], "task#0", draft_tokens=np.zeros(7, np.int32))
        res = b.submit_full(_frames(1)[0], "task#1").result(timeout=30)
        np.testing.assert_array_equal(res.action, np.full(7, 1.0))
        assert res.tokens is None
    finally:
        b.close()
    with DynamicBatcher(DraftStubPolicy(), max_batch=2, max_wait_ms=1.0, drafts=True) as b:
        with pytest.raises(ValueError, match="7 integer token ids"):
            b.submit_full(_frames(1)[0], "task#0", draft_tokens=np.zeros(3, np.int32))


@pytest.mark.parametrize("draft,match", [
    ([0, 0, 0, 0, 0, 0, 99999], "outside"),
    ([0, 0, 0, 0, 0, 0, 32064], "outside"),
    ([-1, 0, 0, 0, 0, 0, 0], "outside"),
    ([2**40] * 7, "outside"),
    ([2**70] * 7, "integer"),
    ([0.0] * 7, "integer"),
    ([True] * 7, "integer"),
    ([[0] * 7], "integer"),
])
def test_submit_full_refuses_a_malformed_draft(draft, match):
    """Only 7 integers in [0, vocab_size) reach a batch: an id past the
    embedding would fail every request of its batch (on the card, every
    later one too), so it fails alone at submit time, and the batcher goes
    on serving."""
    stub = DraftStubPolicy()
    with DynamicBatcher(stub, max_batch=2, max_wait_ms=1.0, drafts=True) as b:
        with pytest.raises(ValueError, match=match):
            b.submit_full(_frames(1)[0], "task#0", draft_tokens=draft)
        ok = b.submit_full(_frames(1)[0], "task#1", draft_tokens=[32063] * 7).result(timeout=30)
    np.testing.assert_array_equal(ok.action, np.full(7, 1.0))
    assert [d.tolist() for _, d in stub.batches] == [[[32063] * 7]]


# ------------------------------------------------------------ serving options
@pytest.mark.parametrize("kwargs,draft", [
    ({"kv_cache": "int8"}, None),
    ({"kv_cache": "int4", "visual_tokens": 8}, None),
    ({"quantize": "w8a8"}, None),
    ({"kv_cache": "int8"}, "last"),
])
def test_policy_options_match_jax_policy(jax_params, kwargs, draft):
    """kv_cache, visual_tokens and quantize='w8a8' reach the decode, and
    draft_tokens="last" the Jacobi tail: the port's VLAPolicy returns the
    JAX VLAPolicy's tokens, actions and verify passes (two calls, so "last"
    drafts the second with the first's tokens)."""
    frames = _frames(2, seed=6)
    want_pol = JaxPolicy(jax_params, VLA_TINY, JaxStub(), STATS, **kwargs)
    got_pol = VLAPolicy(params_from_jax(jax_params, "cpu", T_TINY), T_TINY,
                        WordStubTokenizer(), STATS, device="cpu", **kwargs)
    for _ in range(2 if draft else 1):
        want = want_pol.get_action_multi(frames, TASKS[:2], draft_tokens=draft)
        got = got_pol.get_action_multi(frames, TASKS[:2], draft_tokens=draft)
        np.testing.assert_array_equal(got_pol.last_tokens, want_pol.last_tokens)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert got_pol.last_verify_passes == want_pol.last_verify_passes
    if draft:
        assert got_pol.last_verify_passes == 1


def test_policy_jacobi_draft_control_loop(tiny_policy):
    """draft_tokens="last" reuses the previous call's tokens: the same
    actions, one verify pass on a repeated frame; a cold start or a change of
    batch width runs the Jacobi tail on a zero draft; a [7] array drafts
    get_action."""
    frame = _frames(1, seed=7)[0]
    task = "push the plate forward"
    plain = tiny_policy.get_action_multi(frame[None], [task])
    assert tiny_policy.last_tokens.shape == (1, 7) and tiny_policy.last_verify_passes is None
    drafted = tiny_policy.get_action_multi(frame[None], [task], draft_tokens="last")
    np.testing.assert_array_equal(plain, drafted)
    assert tiny_policy.last_verify_passes == 1
    two = tiny_policy.get_action_multi(np.stack([frame, frame]), [task, task], draft_tokens="last")
    assert tiny_policy.last_verify_passes is not None
    np.testing.assert_array_equal(two[0], plain[0])
    single = tiny_policy.get_action(frame, task, draft_tokens=tiny_policy.last_tokens[0])
    np.testing.assert_array_equal(single, plain[0])
    assert tiny_policy.last_verify_passes == 1
    with pytest.raises(ValueError, match="'last'"):
        tiny_policy.get_action_multi(frame[None], [task], draft_tokens="first")


@pytest.mark.parametrize("kwargs", [{"kv_cache": "int8"}, {"visual_tokens": 4}, {"quantize": "w8a8"}])
def test_load_policy_takes_serving_options(kwargs):
    """The options reach the policy and its decodes give 7 finite actions a
    row; w8a8 holds per-channel int8 weights and quantizes the prefill."""
    pol = load_policy(None, "vla-tiny", device="cpu", **kwargs)
    acts = pol.get_action_batch(_frames(2, seed=8), TASKS[0])
    assert acts.shape == (2, 7) and np.all(np.isfinite(acts))
    opts = {"kv_cache": pol.kv_cache, "visual_tokens": pol.visual_tokens,
            "quantize": "w8a8" if pol.act_quant == "int8" else None}
    assert all(opts[k] == v for k, v in kwargs.items())


def test_policy_refuses_an_unknown_kv_cache():
    with pytest.raises(ValueError, match="kv_cache"):
        load_policy(None, "vla-tiny", device="cpu", kv_cache="fp8")
    with pytest.raises(TypeError, match="unknown decode options"):
        load_policy(None, "vla-tiny", device="cpu").decode(_frames(1), TASKS[:1], mesh=None)


def test_batcher_drafts_round_trip(tiny_policy):
    """drafts=True with the tiny policy: a reply's tokens sent back as the
    next request's draft give the same action in one verify pass, and the
    stats record both batches."""
    with DynamicBatcher(tiny_policy, max_batch=2, max_wait_ms=5.0, drafts=True) as b:
        b.warmup(_frames(1)[0])
        frame = _frames(1, seed=3)[0]
        first = b.submit_full(frame, "stack the cups").result(timeout=120)
        assert first.tokens.shape == (7,)
        second = b.submit_full(frame, "stack the cups", draft_tokens=first.tokens).result(timeout=120)
        np.testing.assert_array_equal(first.action, second.action)
        np.testing.assert_array_equal(first.tokens, second.tokens)
        assert tiny_policy.last_verify_passes == 1
        stats = b.verify_pass_stats()
        assert stats["n"] == 2 and 1 <= stats["max"] <= 6
        np.testing.assert_array_equal(b.get_action(frame, "stack the cups", timeout=120), first.action)


def test_http_drafts_protocol(tiny_policy):
    """A drafts-enabled server replies with tokens, takes them back as
    draft_tokens (a 400 for a draft that is not 7 ints) and reports verify
    passes on /healthz; a plain server answers a draft with a 400."""
    frame = _frames(1, seed=5)[0]
    payload = {"task": "wipe the table", "image": frame.tolist()}
    with ActionServer(tiny_policy, max_batch=2, max_wait_ms=5.0, drafts=True) as srv:
        base = "http://%s:%d" % srv.address
        code, body = _post(base + "/act", payload)
        assert code == 200 and len(body["tokens"]) == 7
        code, body2 = _post(base + "/act", dict(payload, draft_tokens=body["tokens"]))
        assert code == 200 and body2["action"] == body["action"] and body2["tokens"] == body["tokens"]
        code, bad = _post(base + "/act", dict(payload, draft_tokens=[1, 2, 3]))
        assert code == 400 and "7 integer token ids" in bad["error"]
        for ids in ([0, 0, 0, 0, 0, 0, 99999], [2**63] * 7, [-1] * 7):
            code, bad = _post(base + "/act", dict(payload, draft_tokens=ids))
            assert code == 400 and "draft_tokens" in bad["error"], (ids, bad)
        # the malformed drafts never reached a batch: the next request is served
        code, body3 = _post(base + "/act", dict(payload, draft_tokens=body["tokens"]))
        assert code == 200 and body3["tokens"] == body["tokens"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        vp = health["verify_passes"]
        assert vp["n"] == 3 and vp["max"] >= 1 and vp["sum"] >= 3 and health["stats"]["errors"] == 0
    with ActionServer(tiny_policy, max_batch=2, max_wait_ms=1.0) as srv:
        code, body = _post("http://%s:%d/act" % srv.address, dict(payload, draft_tokens=[0] * 7))
        assert code == 400 and "drafts" in body["error"]


def test_serve_cli_serves_drafts_with_options():
    """`python -m roboticattack_torch.cli.serve --model vla-tiny --device cpu
    --drafts --kv_cache int8 --visual_tokens 8` serves /act with
    draft_tokens, replies with tokens and reports verify passes."""
    cmd = [sys.executable, "-m", "roboticattack_torch.cli.serve", "--model", "vla-tiny",
           "--device", "cpu", "--drafts", "--kv_cache", "int8", "--visual_tokens", "8",
           "--port", "0", "--max_batch", "2"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        base = None
        deadline = time.monotonic() + 120
        while base is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving on (http://\S+)", line)
            base = m and m.group(1)
        assert base, "the server did not report its address"
        payload = {"task": "open the drawer", "image": _frames(1, seed=9)[0].tolist()}
        code, body = _post(base + "/act", payload)
        assert code == 200 and len(body["tokens"]) == 7 and np.all(np.isfinite(body["action"]))
        code, body2 = _post(base + "/act", dict(payload, draft_tokens=body["tokens"]))
        assert code == 200 and body2["tokens"] == body["tokens"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["verify_passes"]["n"] == 2 and health["verify_passes"]["mean"] >= 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
