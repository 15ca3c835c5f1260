#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on error:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds every hand-written kernel from roboticattack_torch/csrc
               (one nvcc per source, all started together);
  3. kernels — each kernel against its plain PyTorch version on the card at
               the OpenVLA-7B projection shapes, with times, the byte bound
               and a library yardstick;
  4. slice   — the int4 serving path end to end: random seeded OpenVLA-7B
               weights -> int4 -> VLAPolicy -> DynamicBatcher ->
               ActionServer on 127.0.0.1, answering concurrent HTTP requests;
               the kernel launch count of that run; the same batch through
               the plain int4 path; prefill/tail times and peak memory.
Then one JSON line of per-kernel numbers, the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import json
import math
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

from roboticattack_torch.eval.policy import load_policy
from roboticattack_torch.ops import kernel_build
from roboticattack_torch.ops.q4_matmul import (
    _unpack_nibbles,
    q4_matmul,
    q4_matmul_plain,
    reset_launches,
)
from roboticattack_torch.serving.http import ActionServer

MODEL = "openvla-7b"
SEED = 0
GROUP = 128  # the 7B's int4 group size (models/quant.py int4_group_size_for)
# (label, out, in) of the decode tail's projections; launches per layer
PROJ = [("q/k/v/o_w", 4096, 4096, 4), ("gate/up_w", 11008, 4096, 2), ("down_w", 4096, 11008, 1)]
KERNELS = {
    "grouped": ("q4_matmul_grouped", "roboticattack_tpu/ops/q4_matmul.py:70"),
    "dense": ("q4_matmul_dense", "roboticattack_tpu/ops/q4_matmul.py:96"),
}
SOURCE = "roboticattack_torch/csrc/q4_matmul.cu"
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


def phase_kernels(bw: float):
    """Every kernel against its plain version at the 7B projection shapes;
    timing cycles through enough distinct weight copies to exceed the 50 MB
    L2, as the decode tail (32 layers of weights) finds them cold."""
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
        for m in (1, 8):
            y = torch.randn((m, 1, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
            nbytes = wbytes + out_dim * g * 4 + m * in_dim * 2 + m * out_dim * 2
            byte_ms = nbytes / bw * 1e3
            op_ms = 2 * m * out_dim * in_dim / PEAK_BF16_FLOPS * 1e3
            bound_ms = max(byte_ms, op_ms)
            library_ms = device_ms(lambda i: torch.matmul(y, dense_w[i % len(dense_w)].T))
            for mode in ("grouped", "dense"):
                got = q4_matmul(y, ws[0], scs[0], mode=mode)
                want = q4_matmul_plain(y, ws[0], scs[0], mode, torch.bfloat16)
                torch.cuda.synchronize()
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
                row = dict(mode=mode, shape=label, out=out_dim, inp=in_dim, m=m,
                           per_layer=per_layer, max_abs_err=err, tol=tol, ms=ms, host_ms=host_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           byte_ms=byte_ms, op_ms=op_ms,
                           bound_by="bytes" if byte_ms >= op_ms else "operations",
                           gbps=nbytes / (ms * 1e-3) / 1e9)
                rows.append(row)
                log(f"kernel {KERNELS[mode][0]} {label} [{out_dim}x{in_dim}] m={m}: "
                    f"max_abs_err={err:.3g} (tol {tol:.3g}) kernel_ms={ms:.5f} "
                    f"eager_back_to_back_ms={host_ms:.5f} "
                    f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                    f"(torch.matmul on a pre-dequantized bf16 weight: reads 4x the bytes) "
                    f"bound_ms={bound_ms:.5f} ({row['bound_by']}) "
                    f"achieved={row['gbps']:.0f} GB/s")
        del ws, scs, dense_w
        torch.cuda.empty_cache()
    return rows


def post_act(url: str, frame: np.ndarray, task: str) -> dict:
    body = json.dumps({
        "task": task, "shape": list(frame.shape),
        "image_b64": base64.b64encode(frame.tobytes()).decode(),
    }).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return {"status": resp.status, **json.loads(resp.read())}


def timed_decode(policy, frames, tasks, num_steps: int, reps: int = 3) -> float:
    """Median host ms of one greedy decode of `num_steps` tokens (ends in a
    synchronize)."""
    from roboticattack_torch.models.decode import greedy_decode_actions

    ids, mask, px = policy.prepare(frames, tasks)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            greedy_decode_actions(policy.model.tree(), policy.cfg, ids, mask, px,
                                  num_steps=num_steps, cooked_weights=True,
                                  int4_kernel=policy.int4_kernel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times[1:]))


def device_breakdown(policy, frames, tasks, num_steps: int, wall_ms: float) -> None:
    """torch.profiler over one decode of `num_steps` tokens (1 = the prefill
    alone): device kernel time by name, and the device-busy share against
    the unprofiled wall time `wall_ms` of the same call. Reports
    "not measured" where the profiler gives no device time."""
    from torch.profiler import ProfilerActivity, profile

    from roboticattack_torch.models.decode import greedy_decode_actions

    ids, mask, px = policy.prepare(frames, tasks)

    def run():
        with torch.inference_mode():
            greedy_decode_actions(policy.model.tree(), policy.cfg, ids, mask, px,
                                  num_steps=num_steps, cooked_weights=True,
                                  int4_kernel=policy.int4_kernel)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # device activity only (kernels, copies); CPU ops and runtime markers
    # such as "Command Buffer Full" are not device work
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("Command Buffer")]
    if not kern:
        log("slice: device busy share: not measured (the profiler recorded no device time)")
        return
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
    q4_us = sum(t for name, (_, t) in by_name.items() if "q4_matmul" in name)
    log(f"slice: bs={len(frames)} decode of {num_steps} token(s): device busy {busy_us / 1e3:.2f} ms of {wall_ms:.2f} ms "
        f"wall (unprofiled) -> device busy share {busy_us / 1e3 / wall_ms:.3f}; "
        f"q4_matmul kernels {q4_us / 1e3:.2f} ms")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"slice:   device {t / 1e3:8.3f} ms  x{n:<6d} {name[:100]}")


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
        replies = [None] * N_REQUESTS
        errors = []

        def client(i):
            try:
                replies[i] = post_act(url, frames[i], tasks[i])
            except Exception as e:  # reported below; fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        reset_launches()  # the main path's count starts here
        threads = [threading.Thread(target=client, args=(i,)) for i in range(N_REQUESTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        serve_s = time.perf_counter() - t
        launches = dict(q4_matmul.launches)  # read right after the main path
        decodes = server.batcher.stats["batches"] - batches_before
        bucket_counts = server.batcher.bucket_counts()
    finally:
        server.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"HTTP requests failed: {errors}")
    for i, r in enumerate(replies):
        a = np.asarray(r["action"], np.float64)
        if r["status"] != 200 or a.shape != (7,) or not np.all(np.isfinite(a)):
            raise AssertionError(f"reply {i} is not 7 finite actions: {r}")
    log(f"slice: {N_REQUESTS} concurrent POST /act answered 200 with 7 finite actions each "
        f"in {serve_s:.3f} s over {decodes} decode call(s) (buckets {bucket_counts})")
    log(f"slice: q4_matmul launches in the served run {launches}; expected "
        f"{per_decode} per decode call ({steps} steps x {layers} layers x 7) x {decodes}")
    if launches["grouped"] != per_decode * decodes or decodes < 1:
        raise AssertionError(f"launch count {launches} != {per_decode} x {decodes}")

    # the same batch through the kernel tail and through the plain int4 tail
    kern = policy.decode(frames, tasks)
    policy.int4_kernel = False
    plain = policy.decode(frames, tasks)
    policy.int4_kernel = True
    tk, tp = kern.tokens.cpu().numpy(), plain.tokens.cpu().numpy()
    first_ok = np.array_equal(tk[:, 0], tp[:, 0])
    prefill_logits_equal = torch.equal(kern.logits[:, 0], plain.logits[:, 0])
    agree = float((tk[:, 1:] == tp[:, 1:]).mean())
    # tail logits are comparable while the tokens fed so far agree
    rel = []
    for b in range(tk.shape[0]):
        for i in range(1, tk.shape[1]):
            if not np.array_equal(tk[b, :i], tp[b, :i]):
                break
            lk, lp = kern.logits[b, i].float(), plain.logits[b, i].float()
            rel.append(((lk - lp).norm() / lp.norm()).item())
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
        f"{len(rel)} positions (tol {logits_tol})")
    if not (first_ok and prefill_logits_equal):
        raise AssertionError("first token differs between the kernel and plain int4 paths")
    if not rel or not rel_max <= logits_tol:
        raise AssertionError(f"tail logits rel err {rel_max} > {logits_tol}")

    timings = {}
    for bs in (1, 8):
        pre = timed_decode(policy, frames[:bs], tasks[:bs], num_steps=1)
        full = timed_decode(policy, frames[:bs], tasks[:bs], num_steps=7)
        timings[bs] = (pre, full - pre, full)
        log(f"slice: bs={bs} prefill_ms={pre:.2f} decode_tail_ms={full - pre:.2f} "
            f"(6 steps) decode_total_ms={full:.2f} [{card}]")
    device_breakdown(policy, frames, tasks, 1, timings[8][0])
    device_breakdown(policy, frames, tasks, 7, timings[8][2])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice: peak torch.cuda.max_memory_allocated while serving = {peak:.2f} GiB [{card}]")
    return {"launches": launches, "timings": timings, "peak_gib": peak}


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
        regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
        log(f"build: {lib} in {r['seconds']:.1f} s; " + " | ".join(regs))
    log(f"build: all kernels ready in {time.perf_counter() - t:.1f} s")

    rows = phase_kernels(bw)
    res = phase_slice(card)

    kernels = []
    for mode, (kname, replaces) in KERNELS.items():
        at8 = [r for r in rows if r["mode"] == mode and r["m"] == 8]

        def layer_sum(key):
            return sum(r[key] * r["per_layer"] for r in at8)

        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": res["launches"][mode],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["mode"] == mode),
            "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
            "bound_ms": layer_sum("bound_ms"),
            "bound_by": "bytes" if layer_sum("byte_ms") >= layer_sum("op_ms") else "operations",
            "library_ms": layer_sum("library_ms"),
            "at": "one decoder layer's 7 projections at m=8 (4x 4096x4096, "
                  "2x 11008x4096, 1x 4096x11008), summed per-launch times",
            "on_main_path": mode == "grouped",
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
