#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on error:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds every hand-written kernel from roboticattack_torch/csrc
               (one nvcc per source, all started together);
  3. kernels — each kernel against its plain PyTorch version on the card at
               the OpenVLA-7B projection shapes, with times, the byte bound
               and a library yardstick, at m = 1 and 8 rows (the sequential
               tail) and, for B4, m = 56 (the Jacobi pass at bs 8, y
               [8, 7, in]); both modes also with groups of 32 and 64
               channels, errors only (grouped mode there runs the FMA body);
  4. slice   — the int4 serving path end to end: random seeded OpenVLA-7B
               weights -> int4 -> VLAPolicy -> DynamicBatcher ->
               ActionServer on 127.0.0.1, answering concurrent HTTP requests;
               the kernel launch count of that run; the same batch through
               the plain int4 path; prefill/tail times and peak memory;
  options — the serving options at bs 8 on the same int4 policy: the int8
               and packed-int4 KV caches (prefill logits bit-equal to the
               bf16 cache's, cache bytes from the shapes beside the peak),
               visual_tokens (all patches bit-equal to no pruning; 128),
               Jacobi drafts through a drafts-enabled ActionServer (round 2
               sends round 1's tokens back: equal tokens, 1.0 verify pass a
               batch on /healthz, B4 launches = passes x 32 x 7, all mma;
               zero-draft tokens against the sequential kernel tail); then a
               w8a8 7B policy beside weight-only int8 on its weights; for
               each, prefill/tail wall ms, device busy ms, B4 launches by
               body and peak memory;
  5. flash   — the attention kernels B1/B2 against their plain versions on
               the card (the attack step's shape with a dummy batch's causal
               + padding bias, B=1, a ragged S, an all-zero bias, S=17 inside
               one tile, S=2048), with times, bounds and the
               scaled_dot_product_attention yardstick;
  6. attack  — the attack slice end to end: `cli.attack` (UADA, OpenVLA-7B
               at full width and depth, bf16, random weights, dummy data)
               in-process, its B1/B2 launch count, losses and patches; then
               one outer step's launches, the inner-step time, the device
               breakdown and peak memory; TMA (with the val and clean-filter
               steps) and UPA steps; one inner step's loss and patch gradient
               through the kernels against the plain attention path.
Then one JSON line of per-kernel numbers, the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from roboticattack_torch.attacks import engine
from roboticattack_torch.cli import attack as attack_cli
from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
from roboticattack_torch.eval.policy import load_policy
from roboticattack_torch.models import get_config
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.ops import flash_attention as fa
from roboticattack_torch.ops import kernel_build
from roboticattack_torch.ops.attention import causal_bias, padding_bias
from roboticattack_torch.ops.q4_matmul import (
    _unpack_nibbles,
    q4_matmul,
    q4_matmul_plain,
    reset_launches,
)
from roboticattack_torch.serving.http import ActionServer
from roboticattack_torch.utils.labels import build_tma_target_tokens
from roboticattack_torch.utils.prompting import WordStubTokenizer

MODEL = "openvla-7b"
SEED = 0
VT_KEEP = 128  # visual_tokens of the pruned decode: half the 7B's 256 patches
JACOBI_M = 56  # B4's rows in the Jacobi pass at bs 8: 8 rows x 7 draft positions
M_ROWS = (1, 8, JACOBI_M)
GROUP = 128  # the 7B's int4 group size (models/quant.py int4_group_size_for)
# (label, out, in) of the decode tail's projections; launches per layer
PROJ = [("q/k/v/o_w", 4096, 4096, 4), ("gate/up_w", 11008, 4096, 2), ("down_w", 4096, 11008, 1)]
# mode -> (name, the TPU kernel it replaces, the body the 7B's shapes take)
KERNELS = {
    "grouped": ("q4_matmul_grouped_mma", "roboticattack_tpu/ops/q4_matmul.py:70", "mma"),
    "dense": ("q4_matmul_dense_mma", "roboticattack_tpu/ops/q4_matmul.py:96", "mma"),
}
SOURCE = "roboticattack_torch/csrc/q4_matmul.cu"
FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", "roboticattack_tpu/ops/flash_attention.py:49"),
    "bwd": ("flash_attention_bwd", "roboticattack_tpu/ops/flash_attention.py:66"),
}
FLASH_SOURCE = "roboticattack_torch/csrc/flash_attention.cu"
# the attack slice: bs 8, prompts padded to 32 (multimodal S = 256 + 32),
# 2 inner steps, a 50x50 patch
ATTACK_BS, PAD_TO, INNER, PATCH_HW = 8, 32, 2, (50, 50)
CLI_ITERS, CLI_EVAL_EVERY = 3, 2
DEVICE = "cuda"
N_REQUESTS = 8
MAX_BATCH = 8
# dense bf16 tensor-core peak and memory bandwidth of the H100 SXM (data sheet)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> str:
    """nvcc's -Xptxas -v output, one entry per kernel: its registers, stack
    frame and spills."""
    out, name, frame = [], "?", ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"\d+((?:flash|q4)\w*?kernel)(I\w*?EE)?", ln)
            name = m.group(1) + (m.group(2) or "") if m else ln.split()[-1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
    return " | ".join(out)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def eager_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call of back-to-back eager calls, timed with CUDA events:
    includes the host's launch overhead whenever the host is the slower side."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device ms per call: `calls` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events, so no host launch overhead
    is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def dequant_bf16(w, scale):
    """[out, in/2] packed + [out, G] -> dense bf16 [out, in] (the library
    yardstick's pre-dequantized weight)."""
    lo, hi = _unpack_nibbles(w)
    out_dim, in_half = w.shape
    w8 = torch.stack([lo, hi], dim=-1).reshape(out_dim, scale.shape[1], -1).float()
    return (w8 * scale[..., None]).to(torch.bfloat16).reshape(out_dim, 2 * in_half)


def launch_body(label: str, want: str, fn):
    """fn() through the q4_matmul wrapper; raises unless it launched the body
    `want` ("mma" or "fma")."""
    before = dict(q4_matmul.launches_by_body)
    out = fn()
    torch.cuda.synchronize()
    body = [b for b, n in q4_matmul.launches_by_body.items() if n != before[b]]
    if body != [want]:
        raise AssertionError(f"{label} ran the body {body}, not {want!r}")
    return out


def phase_kernels(bw: float):
    """Every kernel against its plain version at the 7B projection shapes;
    timing cycles through enough distinct weight copies to exceed the 50 MB
    L2, as the decode tail (32 layers of weights) finds them cold. Then both
    modes at 4096x4096, m=8, with groups of 32 and 64 channels, errors only:
    dense mode on the mma body (4 and 2 scales a row a k-block), grouped mode
    on the FMA body. Returns the timed rows and, by mode, the largest error
    of those checks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, out_dim, in_dim, per_layer in PROJ:
        g = in_dim // GROUP
        wbytes = out_dim * in_dim // 2
        nbuf = max(2, math.ceil(200e6 / wbytes))
        ws = [torch.randint(-128, 128, (out_dim, in_dim // 2), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8) for _ in range(nbuf)]
        scs = [(torch.rand((out_dim, g), generator=gen, device="cuda") + 0.5) * 2e-3
               for _ in range(nbuf)]
        dense_w = [dequant_bf16(w, s) for w, s in zip(ws[:4], scs[:4])]
        # m = 1 and 8: the sequential tail's s=1 steps at bs 1 and 8; m = 56:
        # the Jacobi pass at bs 8, y [8, 7, in] (seven row chunks of 8)
        for m in M_ROWS:
            y = torch.randn((m // 7, 7, in_dim) if m == JACOBI_M else (m, 1, in_dim),
                            generator=gen, device="cuda").to(torch.bfloat16)
            nbytes = wbytes + out_dim * g * 4 + m * in_dim * 2 + m * out_dim * 2
            byte_ms = nbytes / bw * 1e3
            op_ms = 2 * m * out_dim * in_dim / PEAK_BF16_FLOPS * 1e3
            bound_ms = max(byte_ms, op_ms)
            library_ms = device_ms(lambda i: torch.matmul(y, dense_w[i % len(dense_w)].T))
            for mode in ("grouped", "dense") if m != JACOBI_M else ("grouped",):
                body = KERNELS[mode][2]
                got = launch_body(f"{mode} {label} m={m}", body,
                                  lambda: q4_matmul(y, ws[0], scs[0], mode=mode))
                want = q4_matmul_plain(y, ws[0], scs[0], mode, torch.bfloat16)
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                # both sum in f32 in different orders and round to bf16: at
                # most a couple of bf16 ulps (2^-8 relative) of the largest output
                tol = 2.0 ** -7 * ref
                if not (err <= tol and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"{mode} {label} m={m}: max_abs_err {err} > tol {tol}")

                def kern(i):
                    return q4_matmul(y, ws[i % nbuf], scs[i % nbuf], mode=mode)

                ms = device_ms(kern)
                host_ms = eager_ms(kern, reps=100)
                plain_ms = device_ms(
                    lambda i: q4_matmul_plain(y, ws[i % nbuf], scs[i % nbuf], mode, torch.bfloat16),
                    calls=4, replays=3)
                row = dict(mode=mode, body=body, shape=label, out=out_dim, inp=in_dim, m=m,
                           per_layer=per_layer, max_abs_err=err, tol=tol, ms=ms, host_ms=host_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           byte_ms=byte_ms, op_ms=op_ms,
                           bound_by="bytes" if byte_ms >= op_ms else "operations",
                           gbps=nbytes / (ms * 1e-3) / 1e9)
                rows.append(row)
                log(f"kernel {KERNELS[mode][0]} ({body} body) {label} [{out_dim}x{in_dim}] m={m}: "
                    f"max_abs_err={err:.3g} (tol {tol:.3g}) kernel_ms={ms:.5f} "
                    f"eager_back_to_back_ms={host_ms:.5f} "
                    f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                    f"(torch.matmul on a pre-dequantized bf16 weight: reads 4x the bytes) "
                    f"bound_ms={bound_ms:.5f} ({row['bound_by']}) "
                    f"achieved={row['gbps']:.0f} GB/s")
        del ws, scs, dense_w
        torch.cuda.empty_cache()
    # groups of 32 and 64: dense mode on the mma body, grouped mode on the
    # FMA body (a grouped partial must belong to one group)
    group_err = {mode: 0.0 for mode in KERNELS}
    for gs in (32, 64):
        w = torch.randint(-128, 128, (4096, 2048), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        sc = (torch.rand((4096, 4096 // gs), generator=gen, device="cuda") + 0.5) * 2e-3
        y = torch.randn((8, 1, 4096), generator=gen, device="cuda").to(torch.bfloat16)
        for mode in KERNELS:
            body = "fma" if mode == "grouped" else KERNELS[mode][2]
            label = f"{mode} [4096x4096] m=8, groups of {gs}"
            got = launch_body(label, body, lambda: q4_matmul(y, w, sc, mode=mode))
            err = check_close(label, got, q4_matmul_plain(y, w, sc, mode, torch.bfloat16))
            group_err[mode] = max(group_err[mode], err)
            log(f"kernel {KERNELS[mode][0] if body == 'mma' else 'q4_matmul_grouped_fma'} ({body} body) "
                f"{label}: max_abs_err={err:.3g} (tol 2^-7 x max|plain|)")
    return rows, group_err


def post_act(url: str, frame: np.ndarray, task: str, draft=None) -> dict:
    payload = {"task": task, "shape": list(frame.shape),
               "image_b64": base64.b64encode(frame.tobytes()).decode()}
    if draft is not None:
        payload["draft_tokens"] = [int(t) for t in draft]
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return {"status": resp.status, **json.loads(resp.read())}


def get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def concurrent_posts(url: str, frames, tasks, drafts=None) -> list:
    """One POST /act a frame, all at once from their own threads; raises
    unless every reply is 200 with 7 finite actions."""
    replies, errors = [None] * len(frames), []

    def client(i):
        try:
            replies[i] = post_act(url, frames[i], tasks[i], None if drafts is None else drafts[i])
        except Exception as e:  # reported below; fails the phase
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"HTTP requests failed: {errors}")
    for i, r in enumerate(replies):
        a = np.asarray(r["action"], np.float64)
        if r["status"] != 200 or a.shape != (7,) or not np.all(np.isfinite(a)):
            raise AssertionError(f"reply {i} is not 7 finite actions: {r}")
    return replies


def decode_call(policy, frames, tasks, num_steps: int, **options):
    """A closure running one greedy decode of `num_steps` tokens
    (`VLAPolicy.decode_inputs`) on inputs prepared once, with the policy's
    decode options overridden by `options` (and draft_tokens [B, 7], cut to
    num_steps); it ends in a synchronize and returns the DecodeResult."""
    inputs = policy.prepare(frames, tasks)
    draft = options.pop("draft_tokens", None)
    if draft is not None:
        draft = torch.as_tensor(np.ascontiguousarray(draft[:, :num_steps]), dtype=torch.int32,
                                device=policy.device)

    def run():
        res = policy.decode_inputs(inputs, draft, num_steps=num_steps, **options)
        torch.cuda.synchronize()
        return res

    return run


def timed_decode(policy, frames, tasks, reps: int = 5, **options):
    """Host ms of the prefill (a decode of 1 token) and of the whole decode
    of 7 tokens, timed in turns (prefill, whole, prefill, whole, ...) after
    one untimed call of each, every call ending in a synchronize: (median
    prefill, median of the turns' differences = the tail, median whole).
    Taking the tail within a turn keeps drifts of the shared host out of
    it."""
    runs = [decode_call(policy, frames, tasks, n, **options) for n in (1, 7)]
    times = []
    for _ in range(reps + 1):
        turn = []
        for run in runs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            turn.append((time.perf_counter() - t) * 1e3)
        times.append(turn)
    pre, full = np.array(times[1:]).T
    return float(np.median(pre)), float(np.median(full - pre)), float(np.median(full))


def device_profile(run, wall_ms: float, label: str, card: str, match=(), top: int = 10) -> dict:
    """torch.profiler over one call of `run` (after one unprofiled call):
    device kernel time by name and the device-busy share against the
    unprofiled wall time `wall_ms` of the same work. Returns the device ms of
    the kernels whose names contain each string of `match`, and the busy ms
    under "busy" ("not measured" when the profiler gives no device time)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # device activity only (kernels, copies); CPU ops and runtime markers
    # such as "Command Buffer Full" are not device work
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("Command Buffer")]
    if not kern:
        log(f"{label}: device busy share: not measured (the profiler recorded no device time)")
        return {m: "not measured" for m in (*match, "busy")}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    found = {m: sum(t for name, (_, t) in by_name.items() if m in name) / 1e3 for m in match}
    log(f"{label}: device busy {busy_us / 1e3:.2f} ms of {wall_ms:.2f} ms wall (unprofiled) -> "
        f"device busy share {busy_us / 1e3 / wall_ms:.3f}; "
        + "; ".join(f"{m} kernels {v:.2f} ms" for m, v in found.items()) + f" [{card}]")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"{label}:   device {t / 1e3:8.3f} ms  x{n:<6d} {name[:100]}")
    return dict(found, busy=busy_us / 1e3)


def device_breakdown(policy, frames, tasks, num_steps: int, wall_ms: float, card: str,
                     label: str = "slice", top: int = 10, **options) -> dict:
    """The device breakdown of one decode of `num_steps` tokens (1 = the
    prefill alone), with the policy's decode options overridden by
    `options`."""
    return device_profile(decode_call(policy, frames, tasks, num_steps, **options), wall_ms,
                          f"{label}: bs={len(frames)} decode of {num_steps} token(s)", card,
                          match=("q4_matmul",), top=top)


def phase_slice(card: str) -> dict:
    t = time.perf_counter()
    policy = load_policy(None, MODEL, quantize="int4", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    cfg = policy.cfg
    steps, layers = 6, cfg.llm.num_layers
    per_decode = steps * layers * 7
    log(f"slice: {MODEL} int4 policy built on the card in {load_s:.1f} s; "
        f"int4_kernel={policy.int4_kernel}; weights resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if not policy.int4_kernel:
        raise AssertionError("int4 on CUDA must resolve int4_kernel to on")

    rng = np.random.default_rng(SEED)
    size = cfg.dino.image_size
    frames = rng.integers(0, 256, (N_REQUESTS, size, size, 3), dtype=np.uint8)
    tasks = [f"pick up the {c} block and place it in bowl {i}"
             for i, c in enumerate(["red", "green", "blue", "yellow",
                                    "white", "black", "orange", "purple"][:N_REQUESTS])]

    torch.cuda.reset_peak_memory_stats()
    server = ActionServer(policy, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                          max_wait_ms=500.0)
    try:
        server.batcher.warmup(frames[0])
        server.start()
        host, port = server.address
        url = f"http://{host}:{port}/act"
        batches_before = server.batcher.stats["batches"]
        reset_launches()  # the main path's count starts here
        t = time.perf_counter()
        try:
            concurrent_posts(url, frames, tasks)
        finally:
            serve_s = time.perf_counter() - t
            launches = dict(q4_matmul.launches)  # read right after the main path
            by_body = dict(q4_matmul.launches_by_body)
        decodes = server.batcher.stats["batches"] - batches_before
        bucket_counts = server.batcher.bucket_counts()
    finally:
        server.shutdown()
    log(f"slice: {N_REQUESTS} concurrent POST /act answered 200 with 7 finite actions each "
        f"in {serve_s:.3f} s over {decodes} decode call(s) (buckets {bucket_counts})")
    log(f"slice: q4_matmul launches in the served run {launches}, by body {by_body}; expected "
        f"{per_decode} per decode call ({steps} steps x {layers} layers x 7) x {decodes}, "
        f"all through the mma body")
    if launches["grouped"] != per_decode * decodes or decodes < 1:
        raise AssertionError(f"launch count {launches} != {per_decode} x {decodes}")
    if by_body != {"mma": launches["grouped"], "fma": 0}:
        raise AssertionError(f"B4 launches by body {by_body}: not all through the mma body")

    # the same batch through the kernel tail and through the plain int4 tail
    kern = policy.decode(frames, tasks)
    plain = policy.decode(frames, tasks, int4_kernel=False)
    tk, tp = kern.tokens.cpu().numpy(), plain.tokens.cpu().numpy()
    first_ok = np.array_equal(tk[:, 0], tp[:, 0])
    prefill_logits_equal = torch.equal(kern.logits[:, 0], plain.logits[:, 0])
    agree = float((tk[:, 1:] == tp[:, 1:]).mean())
    # tail logits are comparable while the tokens fed so far agree
    rel, drift = [], 0.0
    for b in range(tk.shape[0]):
        for i in range(1, tk.shape[1]):
            if not np.array_equal(tk[b, :i], tp[b, :i]):
                break
            lk, lp = kern.logits[b, i].float(), plain.logits[b, i].float()
            rel.append(((lk - lp).norm() / lp.norm()).item())
            drift = max(drift, (lk - lp).abs().max().item())
    rel_max = max(rel) if rel else float("nan")
    # The plain tail rounds every dequantized weight to bf16 (2^-9 relative)
    # where the kernel contracts the exact s4 integers in f32 and scales the
    # f32 group sums; over 32 layers x 7 projections x 6 steps that drifts
    # the logits by a few 1e-2 relative (PERF.md). 0.1 leaves room and still
    # catches a wrong kernel (O(1) error).
    logits_tol = 0.1
    log(f"slice: kernel tail vs plain int4 tail on the same batch: first token equal "
        f"{first_ok} (prefill logits bit-equal {prefill_logits_equal}); token agreement "
        f"on positions 1-6 {agree:.3f}; tail logits max rel err {rel_max:.4g} over "
        f"{len(rel)} positions (tol {logits_tol}), max abs difference {drift:.4g}")
    if not (first_ok and prefill_logits_equal):
        raise AssertionError("first token differs between the kernel and plain int4 paths")
    if not rel or not rel_max <= logits_tol:
        raise AssertionError(f"tail logits rel err {rel_max} > {logits_tol}")

    timings = {}
    for bs in (1, 8):
        pre, tail, full = timed_decode(policy, frames[:bs], tasks[:bs])
        timings[bs] = (pre, tail, full)
        log(f"slice: bs={bs} prefill_ms={pre:.2f} decode_tail_ms={tail:.2f} "
            f"(6 steps) decode_total_ms={full:.2f} [{card}]")
    device_breakdown(policy, frames, tasks, 1, timings[8][0], card)
    device_breakdown(policy, frames, tasks, 7, timings[8][2], card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice: peak torch.cuda.max_memory_allocated while serving = {peak:.2f} GiB [{card}]")
    return {"launches": launches, "by_body": by_body, "timings": timings, "peak_gib": peak,
            "policy": policy, "frames": frames, "tasks": tasks, "base": kern, "drift": drift}


def cache_gb(cfg, bs: int, total: int, mode) -> float:
    """The KV cache's bytes (GB, 1e9) reckoned from its shapes."""
    from roboticattack_torch.models.decode import kv_cache_shapes

    shapes = kv_cache_shapes(cfg.llm, bs, total, mode, torch.bfloat16)
    return sum(math.prod(s) * torch.empty((), dtype=dt).element_size() for s, dt in shapes.values()) / 1e9


def first_flips(seq, tokens) -> list:
    """Per row, the first position where `tokens` leave the sequential
    decode `seq` (a DecodeResult with logits); both were fed the same tokens
    before it. (row, position, the sequential logits' margin there of their
    own token over the one `tokens` chose)."""
    out = []
    st = seq.tokens.cpu().numpy()
    for b in range(st.shape[0]):
        diff = np.nonzero(st[b] != np.asarray(tokens[b]))[0]
        if len(diff):
            j = int(diff[0])
            lg = seq.logits[b, j].float()
            out.append((b, j, (lg[int(st[b, j])] - lg[int(tokens[b][j])]).item()))
    return out


def phase_options(sl: dict, card: str) -> dict:
    """The single-device serving options on the slice phase's int4 7B policy
    at bs=8 (and a w8a8 7B policy): the int8 and int4 KV caches, visual-token
    pruning, the w8a8 prefill against weight-only int8, and Jacobi drafts
    through HTTP; for each, prefill/tail wall ms, device busy ms, B4
    launches by body and peak memory."""
    from roboticattack_torch.eval.policy import VLAPolicy

    policy, frames, tasks, base = sl["policy"], sl["frames"], sl["tasks"], sl["base"]
    cfg = policy.cfg
    bs, per_pass = len(frames), cfg.llm.num_layers * 7
    total = 1 + cfg.num_patches + policy.prompt_pad - 1 + 7  # prefix slots + 7 decode slots
    base_tok = base.tokens.cpu().numpy()
    rows = {}

    def run_option(label, pol, want_b4=None, **opts):
        """One bs=8 decode with `opts` (B4 launches by body and peak memory
        over it), then prefill and whole-decode wall times and the device
        breakdown of the whole decode."""
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = decode_call(pol, frames, tasks, 7, **opts)()
        b4 = dict(q4_matmul.launches_by_body)
        peak = torch.cuda.max_memory_allocated() / 2**30
        acts = res.actions.cpu().numpy()
        if acts.shape != (bs, 7) or not np.all(np.isfinite(acts)):
            raise AssertionError(f"{label}: actions {acts.shape} not 7 finite a row")
        if want_b4 is not None and b4 != {"mma": want_b4(res), "fma": 0}:
            raise AssertionError(f"{label}: B4 launches by body {b4}, expected {want_b4(res)} on the mma body")
        pre, tail, full = timed_decode(pol, frames, tasks, **opts)
        busy = device_breakdown(pol, frames, tasks, 7, full, card, label=f"options {label}", top=3,
                                **opts)["busy"]
        row = dict(prefill_ms=pre, tail_ms=tail, total_ms=full, busy_ms=busy, b4=b4,
                   peak_gib=peak, resident_gib=resident, passes=res.verify_passes)
        rows[label] = row
        log(f"options: {label} bs={bs}: prefill_ms={pre:.2f} tail_ms={tail:.2f} "
            f"total_ms={full:.2f} device_busy_ms={busy if isinstance(busy, str) else f'{busy:.2f}'} "
            f"verify_passes={res.verify_passes} B4 launches by body {b4} peak {peak:.2f} GiB "
            f"(resident before {resident:.2f} GiB) [{card}]")
        return res

    seq = per_pass * 6
    run_option("bf16 cache (the slice path)", policy, lambda r: seq)

    # --- KV cache int8 / int4
    for mode in ("int8", "int4"):
        label = f"kv_cache={mode}"
        res = run_option(label, policy, lambda r: seq, kv_cache=mode)
        tok = res.tokens.cpu().numpy()
        prefill_equal = torch.equal(res.logits[:, 0], base.logits[:, 0])
        agree = float((tok[:, 1:] == base_tok[:, 1:]).mean())
        gb, gb_bf16 = cache_gb(cfg, bs, total, mode), cache_gb(cfg, bs, total, None)
        rows[label].update(cache_gb=gb, agree=agree)
        log(f"options: {label}: prefill logits bit-equal to the bf16-cache decode {prefill_equal}, first "
            f"token equal {np.array_equal(tok[:, 0], base_tok[:, 0])}; tail-token agreement with the "
            f"bf16 cache {agree:.3f}; cache {gb:.4f} GB from its shapes at total={total} (bf16 cache "
            f"{gb_bf16:.4f} GB) beside a peak of {rows[label]['peak_gib']:.2f} GiB, "
            f"{rows[label]['peak_gib'] - rows[label]['resident_gib']:.2f} GiB above the resident weights [{card}]")
        if not (prefill_equal and np.array_equal(tok[:, 0], base_tok[:, 0])):
            raise AssertionError(f"{label}: the prefill logits or first token differ from the bf16 cache's")

    # --- visual tokens
    allv = decode_call(policy, frames, tasks, 7, visual_tokens=cfg.num_patches)()
    if not (torch.equal(allv.tokens, base.tokens) and torch.equal(allv.logits, base.logits)):
        raise AssertionError(f"visual_tokens={cfg.num_patches} differs from no pruning")
    run_option(f"visual_tokens={VT_KEEP}", policy, lambda r: seq, visual_tokens=VT_KEEP)
    log(f"options: visual_tokens={cfg.num_patches} gives tokens and logits bit-equal to no pruning; "
        f"visual_tokens={VT_KEEP} prefill {rows[f'visual_tokens={VT_KEEP}']['prefill_ms']:.2f} ms against "
        f"{rows['bf16 cache (the slice path)']['prefill_ms']:.2f} ms unpruned; cache "
        f"{cache_gb(cfg, bs, total - cfg.num_patches + VT_KEEP, None):.4f} GB [{card}]")

    # --- Jacobi drafts through HTTP: round 1 without drafts, round 2 sends
    # each client's round-1 tokens back for the same frame and task
    server = ActionServer(policy, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                          max_wait_ms=500.0, drafts=True)
    try:
        server.batcher.warmup(frames[0])
        server.start()
        base_url = "http://%s:%d" % server.address
        reset_launches()  # the Jacobi path's count starts here
        r1 = concurrent_posts(base_url + "/act", frames, tasks)
        l1 = dict(q4_matmul.launches_by_body)
        h1 = get_json(base_url + "/healthz")["verify_passes"]
        reset_launches()
        r2 = concurrent_posts(base_url + "/act", frames, tasks, drafts=[r["tokens"] for r in r1])
        l2 = dict(q4_matmul.launches_by_body)  # read right after the main path
        h2 = get_json(base_url + "/healthz")["verify_passes"]
    finally:
        server.shutdown()
    t1 = np.array([r["tokens"] for r in r1])
    t2 = np.array([r["tokens"] for r in r2])
    # /healthz sums the passes over all drafted batches: round 2's are the
    # difference
    p1 = h1["sum"]
    p2, n2 = h2["sum"] - h1["sum"], h2["n"] - h1["n"]
    log(f"options: Jacobi through HTTP, {bs} clients: round 1 (no draft) {h1['n']} batch(es), "
        f"{p1} verify passes, B4 {l1}; round 2 (round-1 tokens as drafts) {n2} batch(es), "
        f"{p2} verify passes ({p2 / max(n2, 1):.2f} a batch), B4 {l2}; round-2 tokens equal "
        f"round 1's {np.array_equal(t1, t2)}; /healthz {h2}")
    if not np.array_equal(t1, t2):
        raise AssertionError("round-2 tokens differ from round 1's")
    if n2 < 1 or p2 != n2:
        raise AssertionError(f"round 2 ran {p2} verify passes over {n2} batches, not 1.0 a batch")
    if l1 != {"mma": p1 * per_pass, "fma": 0} or l2 != {"mma": p2 * per_pass, "fma": 0}:
        raise AssertionError(f"B4 launches {l1}, {l2} != passes x {per_pass}, all on the mma body")
    # Jacobi and the sequential tail compute the same logits in another
    # order, so a token may flip only where the sequential margin of its
    # token over Jacobi's is within what two correct computations drift
    # apart: 2x the largest |logit difference| between the kernel and plain
    # tails (slice phase, this run). A wrong pass (rope, mask, cache slot)
    # picks tokens far below the top, at margins of a few % of the logits.
    flips, bound = first_flips(base, t1), 2 * sl["drift"]
    log(f"options: zero-draft Jacobi tokens vs the sequential kernel tail: equal on "
        f"{float((t1 == base_tok).mean()):.3f} of the positions; first differing positions "
        f"(row, position, sequential margin of its token over Jacobi's) {flips}; bound {bound:.4g} "
        f"(2x the kernel-vs-plain tail drift {sl['drift']:.4g})")
    if any(m > bound for _, _, m in flips):
        raise AssertionError(f"Jacobi tokens leave the sequential tail at a margin above {bound:.4g}: {flips}")
    run_option("Jacobi, zero draft", policy, lambda r: r.verify_passes * per_pass,
               draft_tokens=np.zeros((bs, 7), np.int32))
    run_option("Jacobi, round-1 tokens as draft", policy, lambda r: r.verify_passes * per_pass,
               draft_tokens=t1)
    log(f"options: Jacobi tail with a correct draft {rows['Jacobi, round-1 tokens as draft']['tail_ms']:.2f} ms "
        f"against the sequential tail {rows['bf16 cache (the slice path)']['tail_ms']:.2f} ms [{card}]")

    # --- w8a8 against weight-only int8 on the same weights
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    w8a8 = load_policy(None, MODEL, quantize="w8a8", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    int8 = VLAPolicy(w8a8.model.tree(), cfg, w8a8.tokenizer, w8a8.norm_stats, w8a8.unnorm_key,
                     cooked_weights=True, quantize="int8", device="cuda")
    log(f"options: {MODEL} w8a8 policy built in {time.perf_counter() - t:.1f} s; the int8 policy "
        f"shares its weights (quantize='int8' of the same seed gives the same bytes)")
    # the card's int8 x int8 -> int32 product (torch._int_mm) at a prefill
    # projection's shape against the exact integer product (f64 sums of
    # products below 2^53 are exact)
    from roboticattack_torch.models.decode import _int8_matmul, _quantize_act

    q_w = w8a8.model.tree()["llm"]["layers"]["q_w"][0]
    gen = torch.Generator(device=q_w.device).manual_seed(SEED)
    yq, _ = _quantize_act(torch.randn((bs, total - 7, q_w.shape[1]), generator=gen, device=q_w.device))
    prod = _int8_matmul(yq, q_w)
    exact = (yq.double() @ q_w.double().T).to(torch.int64)
    log(f"options: w8a8 int8 product {list(yq.shape)} x {list(q_w.shape)}^T on the card equals the "
        f"exact integer product: {torch.equal(prod.to(torch.int64), exact)}")
    if not torch.equal(prod.to(torch.int64), exact):
        raise AssertionError("torch._int_mm on the card differs from the exact integer product")
    del yq, prod, exact
    a8 = run_option("w8a8", w8a8, lambda r: 0)
    w8 = run_option("int8 weight-only", int8, lambda r: 0)
    ta, tw = a8.tokens.cpu().numpy(), w8.tokens.cpu().numpy()
    la, lw = a8.logits[:, 0].float(), w8.logits[:, 0].float()
    rel = ((la - lw).norm(dim=-1) / lw.norm(dim=-1)).max().item()
    log(f"options: w8a8 vs int8 weight-only: token agreement {float((ta == tw).mean()):.3f} "
        f"(first token {float((ta[:, 0] == tw[:, 0]).mean()):.3f}); prefill logits max rel diff "
        f"{rel:.4g}; prefill {rows['w8a8']['prefill_ms']:.2f} vs {rows['int8 weight-only']['prefill_ms']:.2f} ms [{card}]")
    del w8a8, int8, a8, w8
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "jacobi_launches": {"round 1": l1, "round 2": l2}, "passes": (p1, p2)}


def dummy_batches(bs: int, seed: int = SEED):
    """The attack's dummy batches (numpy), OpenVLA-7B frame size."""
    size = get_config(MODEL).dino.image_size
    return batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=size, seed=seed),
                          bs, pad_to=PAD_TO)


def slice_bias(batch, num_patches: int) -> torch.Tensor:
    """The decoder's f32 [B, S, S] causal + padding bias of a dummy batch: the
    patch tokens after BOS are always attended, padded text keys are not."""
    mask = torch.as_tensor(np.asarray(batch.attention_mask), device="cuda")
    ones = torch.ones((mask.shape[0], num_patches), dtype=mask.dtype, device="cuda")
    mm = torch.cat([mask[:, :1], ones, mask[:, 1:]], dim=1)
    s = mm.shape[1]
    return (causal_bias(s, s, device="cuda") + padding_bias(mm))[:, 0].contiguous()


def attention_bounds(b: int, h: int, s: int, d: int, bw: float) -> dict:
    """Least times of B1 and B2 at [b, h, s, d]: each input read once, each
    output written once, over the memory rate; the products' operations over
    the bf16 tensor-core peak (the inputs are bf16)."""
    qkv = b * h * s * d * 2
    bias = b * s * s * 4
    stats = 2 * b * h * s * 4  # the row max and sum of exp
    out = {}
    for kind, nbytes, flops in (("fwd", 4 * qkv + bias + stats, 4 * s * s * d * b * h),
                                ("bwd", 7 * qkv + bias + stats, 10 * s * s * d * b * h)):
        byte_ms, op_ms = nbytes / bw * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        out[kind] = dict(bytes=nbytes, flops=flops, byte_ms=byte_ms, op_ms=op_ms,
                         bound_ms=max(byte_ms, op_ms),
                         bound_by="bytes" if byte_ms >= op_ms else "operations")
    return out


def check_close(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Both sides sum in f32 in different orders and round to bf16: within a
    couple of bf16 ulps (2^-8 relative) of the largest value."""
    err = (got.float() - want.float()).abs().max().item()
    tol = 2.0 ** -7 * want.float().abs().max().item()
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{label}: max_abs_err {err} > tol {tol} (or not finite)")
    return err


def phase_flash(bw: float, card: str) -> dict:
    """B1 and B2 against their plain versions on the card; times at the
    attack step's shape."""
    cfg = get_config(MODEL)
    h, d = cfg.llm.num_heads, cfg.llm.head_dim
    s = cfg.num_patches + PAD_TO
    bias8 = slice_bias(next(dummy_batches(ATTACK_BS)), cfg.num_patches)
    def causal(b, n):
        return causal_bias(n, n, device="cuda")[:, 0].expand(b, n, n).contiguous()

    cases = [  # label, q/k/v shape, bias
        ("attack shape, dummy-batch bias", (ATTACK_BS, h, s, d), bias8),
        ("B=1", (1, h, s, d), bias8[:1].contiguous()),
        ("ragged S=100", (2, 8, 100, d), causal(2, 100)),
        ("all-zero bias", (2, 8, 128, d), torch.zeros((2, 128, 128), device="cuda")),
        ("S=17, inside one tile", (2, 8, 17, d), causal(2, 17)),
        ("S=2048 = MAX_SEQ", (1, 4, fa.MAX_SEQ, d), causal(1, fa.MAX_SEQ)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    timing = {}
    for label, shape, bias in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
        o, m, l = fa.flash_attention_fwd(q, k, v, bias)
        grads = fa.flash_attention_bwd(q, k, v, bias, do, m, l)
        torch.cuda.synchronize()
        e_fwd = check_close(f"B1 {label}", o, fa.flash_attention_fwd_plain(q, k, v, bias))
        e_bwd = max(check_close(f"B2 {label} d{n}", g, w) for n, g, w in
                    zip("qkv", grads, fa.flash_attention_bwd_plain(q, k, v, bias, do)))
        errs["fwd"], errs["bwd"] = max(errs["fwd"], e_fwd), max(errs["bwd"], e_bwd)
        log(f"flash: {label} {list(shape)}: B1 max_abs_err={e_fwd:.4g}, B2 max_abs_err={e_bwd:.4g} "
            f"(tol 2^-7 x max|plain| each)")
        if timing:
            continue
        # times at the attack step's shape
        bounds = attention_bounds(*shape, bw)
        mask = bias[:, None].to(torch.bfloat16)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def lib_fwd_bwd(_):
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            torch.autograd.grad(out, (qg, kg, vg), do)

        # device time, as the kernels': eager timing of the backward reads
        # the host's autograd launch path whenever the host is slow
        lib_fwd = device_ms(lambda _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        lib_both = device_ms(lib_fwd_bwd)
        timing = {
            "fwd": dict(ms=device_ms(lambda _: fa.flash_attention_fwd(q, k, v, bias)),
                        plain_ms=device_ms(lambda _: fa.flash_attention_fwd_plain(q, k, v, bias),
                                           calls=4, replays=3),
                        library_ms=lib_fwd, **bounds["fwd"]),
            "bwd": dict(ms=device_ms(lambda _: fa.flash_attention_bwd(q, k, v, bias, do, m, l)),
                        plain_ms=device_ms(lambda _: fa.flash_attention_bwd_plain(q, k, v, bias, do),
                                           calls=4, replays=3),
                        library_ms=lib_both - lib_fwd, **bounds["bwd"]),
        }
        for kind, t in timing.items():
            log(f"flash: {FLASH_KERNELS[kind][0]} {list(shape)}: kernel_ms={t['ms']:.5f} "
                f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
                f"(scaled_dot_product_attention with a bf16 additive mask"
                f"{'' if kind == 'fwd' else ', forward+backward minus forward'}; CUDA-graph replay) "
                f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: {t['bytes'] / 1e6:.2f} MB -> "
                f"{t['byte_ms']:.5f} ms, {t['flops'] / 1e9:.2f} GFLOP -> {t['op_ms']:.5f} ms) "
                f"achieved {t['flops'] / (t['ms'] * 1e-3) / 1e12:.2f} TFLOP/s [{card}]")
        del qg, kg, vg
    return {"timing": timing, "errs": errs}


def attack_flops(cfg, bs: int, text_len: int) -> float:
    """Matmul FLOPs of one inner step derived from the config: the forward,
    plus the input gradient (1x a linear layer's forward, 2x an attention
    product's), the recompute not counted."""

    def vit(vc):
        t = vc.num_patches + vc.num_prefix_tokens
        d = vc.embed_dim
        lin = vc.num_patches * 2 * vc.patch_size ** 2 * 3 * d
        lin += vc.tap_layer * t * 2 * (3 * d * d + d * d + 2 * d * vc.mlp_hidden)
        return lin, vc.tap_layer * 4 * t * t * d

    llm = cfg.llm
    d, hd = llm.hidden_size, llm.head_dim
    s = cfg.num_patches + text_len
    lin = s * llm.num_layers * 2 * (d * llm.num_heads * hd + 2 * d * llm.num_kv_heads * hd
                                    + llm.num_heads * hd * d + 3 * d * llm.intermediate_size)
    lin += text_len * 2 * d * llm.vocab_size
    attn = llm.num_layers * 4 * s * s * hd * llm.num_heads
    vdim = cfg.vision_dim
    lin += cfg.num_patches * 2 * (vdim * 4 * vdim + 4 * vdim * d + d * d)
    for vc in (cfg.dino, cfg.siglip):
        v_lin, v_attn = vit(vc)
        lin, attn = lin + v_lin, attn + v_attn
    return bs * (2 * lin + 3 * attn)


def phase_attack(card: str) -> dict:
    """The attack slice (main path: the CLI), then direct steps."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_attack_")
    argv = ["--attack", "uada", "--model", MODEL, "--dataset", "dummy", "--iter", str(CLI_ITERS),
            "--innerLoop", str(INNER), "--bs", str(ATTACK_BS), "--pad_to", str(PAD_TO),
            "--warmup", "0", "--eval_every", str(CLI_EVAL_EVERY), "--eval_batches", "1",
            "--seed", str(SEED), "--device", DEVICE, "--output", out_dir]
    layers = get_config(MODEL).llm.num_layers
    evals = len(range(0, CLI_ITERS, CLI_EVAL_EVERY))
    want = {"fwd": CLI_ITERS * INNER * 2 * layers + evals * layers, "bwd": CLI_ITERS * INNER * layers}
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # the main path's count starts here
        t = time.perf_counter()
        attack_cli.main(argv)
        torch.cuda.synchronize()
        launches = dict(fa.flash_attention.launches)  # read right after the main path
        cli_s = time.perf_counter() - t
        log(f"attack: `python -m roboticattack_torch.cli.attack {' '.join(argv[:-4])}` ran in "
            f"{cli_s:.1f} s (weight init included); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"attack: B1/B2 launches in the CLI run {launches}; expected {want} "
            f"({CLI_ITERS} steps x {INNER} inner x (2 x {layers} B1 with remat, {layers} B2) + "
            f"{evals} val forwards x {layers} B1)")
        if launches != want:
            raise AssertionError(f"CLI launch count {launches} != {want}")
        lines = [json.loads(ln) for ln in open(os.path.join(out_dir, "run-metrics.jsonl"))]
        losses = [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln]
        vals = [ln for ln in lines if any(k.startswith("VAL_") for k in ln)]
        if len(losses) != CLI_ITERS or not np.all(np.isfinite(losses)) or len(vals) != evals:
            raise AssertionError(f"CLI losses {losses}, {len(vals)} val lines")
        log(f"attack: TRAIN_loss per step {losses}; VAL lines {[{k: v for k, v in ln.items() if k.startswith('VAL')} for ln in vals]}")
        init = torch.rand((*PATCH_HW, 3), generator=torch.Generator().manual_seed(SEED))
        for tag in ("final", "last"):
            chw = torch.load(os.path.join(out_dir, tag, "patch.pt"), weights_only=True)
            if tuple(chw.shape) != (3, *PATCH_HW) or chw.min() < 0 or chw.max() > 1:
                raise AssertionError(f"{tag}/patch.pt: shape {tuple(chw.shape)}, range "
                                     f"[{chw.min().item()}, {chw.max().item()}]")
            moved = (chw.permute(1, 2, 0) - init).abs().max().item()
            if moved == 0.0:
                raise AssertionError(f"{tag}/patch.pt did not move from the initial patch")
            log(f"attack: {tag}/patch.pt [3, 50, 50] in [{chw.min().item():.4f}, {chw.max().item():.4f}], "
                f"max |change| from the initial patch {moved:.4g}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(MODEL)
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    batches = dummy_batches(ATTACK_BS)
    batch = engine.batch_to_device(next(batches), DEVICE)
    gen = torch.Generator().manual_seed(SEED)

    def draws_for(spec, inner=None):
        return engine.draw_step(gen, spec, batch.images.shape, PATCH_HW, batch.labels.shape, inner)

    def fresh_state():
        return engine.init_attack_state(torch.Generator().manual_seed(SEED), PATCH_HW, DEVICE)

    spec = engine.AttackSpec(objective="uada", inner_loop=INNER)
    step = engine.make_attack_step(spec, cfg, None, range(7))
    state = fresh_state()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    state, metrics = step(params, state, batch, 2e-3, True, draws_for(spec))
    torch.cuda.synchronize()
    one = dict(fa.flash_attention.launches)
    want_one = {"fwd": INNER * 2 * layers, "bwd": INNER * layers}
    log(f"attack: one outer step (UADA, {INNER} inner) launched B1/B2 {one}; expected {want_one}")
    if one != want_one:
        raise AssertionError(f"outer-step launch count {one} != {want_one}")
    times = []
    for _ in range(4):
        draws = draws_for(spec)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(params, state, batch, 2e-3, True, draws)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
            raise AssertionError(f"non-finite UADA metrics {metrics}")
    inner_ms = float(np.median(times)) / INNER
    flops = attack_flops(cfg, ATTACK_BS, PAD_TO)
    log(f"attack: UADA outer step ({INNER} inner) host ms {[round(x, 2) for x in times]}; "
        f"inner step {inner_ms:.2f} ms (median / {INNER}); matmul FLOPs per inner step "
        f"(forward + input gradient, from the config) {flops / 1e12:.2f} TFLOP -> "
        f"{flops / (inner_ms * 1e-3) / 1e12:.1f} TFLOP/s = {flops / (inner_ms * 1e-3) / PEAK_BF16_FLOPS:.3f} "
        f"of the 989 TFLOP/s bf16 peak [{card}]")
    last = {k: float(v[-1]) for k, v in metrics.items()}
    log(f"attack: UADA metrics of the last inner step {last}")

    def run_step():
        step(params, state, batch, 2e-3, True, draws_for(spec))
        torch.cuda.synchronize()

    found = device_profile(run_step, inner_ms * INNER, f"attack: one UADA outer step ({INNER} inner)",
                           card, match=("flash_fwd_kernel", "flash_bwd_", "nvjet", "gemm"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"attack: peak torch.cuda.max_memory_allocated over the UADA steps = {peak:.2f} GiB [{card}]")

    # TMA on the gripper dim, with the val and clean-filter steps
    maskidx = [6]
    target = build_tma_target_tokens(np.zeros(7), maskidx)
    tspec = engine.AttackSpec(objective="tma", inner_loop=1)
    tstate, tm = engine.make_attack_step(tspec, cfg, target, maskidx)(
        params, fresh_state(), batch, 2e-3, True, draws_for(tspec))
    val = engine.make_val_step(tspec, cfg, target, maskidx)(params, tstate.patch, batch, draws_for(tspec, 1))
    clean = engine.make_clean_filter_step(cfg)(params, batch)
    patched = val.pop("_patched_images")
    finite = all(bool(torch.isfinite(v.float()).all()) for v in list(tm.values()) + list(val.values()))
    if not finite or clean.shape != (ATTACK_BS,) or patched.shape != batch.images.shape:
        raise AssertionError(f"TMA step / val / clean filter: finite {finite}, clean {tuple(clean.shape)}")
    log(f"attack: TMA step (maskidx [6]) loss {tm['loss'].tolist()} l1 {tm['l1'].tolist()}; val loss "
        f"{val['loss'].item():.5g} ex_l1 {val['ex_l1'].tolist()}; clean-filter {clean.tolist()}")
    # UPA with the L1 gradient clip
    uspec = engine.AttackSpec(objective="upa", inner_loop=1, grad_clip_l1=1e-3)
    _, um = engine.make_attack_step(uspec, cfg, None, range(7))(
        params, fresh_state(), batch, 2e-3, True, draws_for(uspec))
    if not all(bool(torch.isfinite(v).all()) for v in um.values()):
        raise AssertionError(f"non-finite UPA metrics {um}")
    log(f"attack: UPA step (L1 clip 1e-3) loss {um['loss'].tolist()} angle {um['angle'].tolist()}")

    # one inner step through the kernels against the plain attention path
    labels = engine.prepare_labels(spec, batch.labels, None, range(7), None)
    d = draws_for(spec, 1).inner[0]
    xla_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"))
    loss_f, _, grad_f = engine.patch_loss_and_grad(spec, cfg, params, state.patch, batch, labels, d)
    loss_x, _, grad_x = engine.patch_loss_and_grad(spec, xla_cfg, params, state.patch, batch, labels, d)
    rel = abs(loss_f.item() - loss_x.item()) / abs(loss_x.item())
    cos = F.cosine_similarity(grad_f.flatten(), grad_x.flatten(), dim=0).item()
    log(f"attack: kernel path vs plain attention (attn_impl='xla'): loss {loss_f.item():.6g} vs "
        f"{loss_x.item():.6g} (rel diff {rel:.3g}, tol 1e-2); patch-gradient cosine {cos:.6f} (tol 0.99)")
    if not (rel <= 1e-2 and cos >= 0.99):
        raise AssertionError(f"kernel path disagrees with the plain path: rel {rel}, cosine {cos}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "inner_ms": inner_ms, "device": found, "peak_gib": peak,
            "rel": rel, "cos": cos}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x{torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {card}")
    bw = hbm_rate(name)

    t = time.perf_counter()
    report = kernel_build.build_all()
    for lib, r in report.items():
        log(f"build: {lib} in {r['seconds']:.1f} s; {ptxas_report(r['log'])}")
    log(f"build: all kernels ready in {time.perf_counter() - t:.1f} s")

    rows, group_err = phase_kernels(bw)
    res = phase_slice(card)
    opts = phase_options(res, card)
    for key in ("policy", "base"):  # the int4 policy of the serving phases
        del res[key]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"freed the serving phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    flash = phase_flash(bw, card)
    att = phase_attack(card)

    kernels = []
    for kind, (kname, replaces) in FLASH_KERNELS.items():
        t = flash["timing"][kind]
        kernels.append({
            "name": kname, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": att["launches"][kind], "max_abs_err": flash["errs"][kind],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "at": f"[{ATTACK_BS}, 32, {256 + PAD_TO}, 128] bf16 with a dummy batch's causal + "
                  "padding bias, per launch; launches from the CLI run",
            "on_main_path": True,
        })
    for mode, (kname, replaces, body) in KERNELS.items():
        def layer_sum(key, m=8):
            return sum(r[key] * r["per_layer"] for r in rows if r["mode"] == mode and r["m"] == m)

        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "body": body, "launches": res["launches"][mode],
            "max_abs_err": max([r["max_abs_err"] for r in rows if r["mode"] == mode]
                               + [group_err[mode]]),
            "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
            "bound_ms": layer_sum("bound_ms"),
            "bound_by": "bytes" if layer_sum("byte_ms") >= layer_sum("op_ms") else "operations",
            "library_ms": layer_sum("library_ms"),
            "at": "one decoder layer's 7 projections at m=8 (4x 4096x4096, "
                  "2x 11008x4096, 1x 4096x11008), summed per-launch times",
            "max_abs_err_over": "the 7B shapes at m=1 and 8, and 4096x4096 at m=8 with groups of "
                                f"32 and 64 ({'on the fma body' if mode == 'grouped' else 'on the mma body'})",
            "on_main_path": mode == "grouped",
        })
        if mode == "grouped":
            m56 = [r for r in rows if r["mode"] == mode and r["m"] == JACOBI_M]
            kernels[-1].update({
                "launches_by_path": {"slice (HTTP, sequential tail)": res["launches"][mode],
                                     **{f"options Jacobi HTTP {k}": v["mma"] + v["fma"]
                                        for k, v in opts["jacobi_launches"].items()}},
                "jacobi_verify_passes": {"round 1": opts["passes"][0], "round 2": opts["passes"][1]},
                "ms_m56": layer_sum("ms", JACOBI_M), "plain_ms_m56": layer_sum("plain_ms", JACOBI_M),
                "bound_ms_m56": layer_sum("bound_ms", JACOBI_M),
                "library_ms_m56": layer_sum("library_ms", JACOBI_M),
                "max_abs_err_m56": max(r["max_abs_err"] for r in m56),
                "at_m56": "the Jacobi pass at bs 8, y [8, 7, in]: one layer's 7 projections, "
                          "summed per-launch times",
            })
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
