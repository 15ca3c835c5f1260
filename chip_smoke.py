#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on error:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — builds every hand-written kernel from roboticattack_torch/csrc
               (one nvcc per source, all started together);
  3. kernels — each kernel against its plain PyTorch version on the card at
               the OpenVLA-7B projection shapes, with times, the byte bound
               and a library yardstick, at m = 1, 2 and 8 rows (the sequential
               tail at bs 1, 2 and 8) and, for B4, m = 56 (the Jacobi pass at
               bs 8, y [8, 7, in]); B4 with groups of 128, 64 and 32 channels
               (all timed), and at m = 57 and 64 (errors only); B5 also with
               groups of 32 and 64, errors only; every check bit-equal across
               two launches;
  4. slice   — the int4 serving path end to end: random seeded OpenVLA-7B
               weights -> int4 -> VLAPolicy -> DynamicBatcher ->
               ActionServer on 127.0.0.1, answering concurrent HTTP requests;
               the B4 and the norm kernels' launch counts of that run; the same batch through
               the plain int4 path; prefill/tail times and peak memory;
  options — the serving options at bs 8 on the same int4 policy: the int8
               and packed-int4 KV caches (prefill logits bit-equal to the
               bf16 cache's, cache bytes from the shapes beside the peak),
               visual_tokens (all patches bit-equal to no pruning; 128),
               Jacobi drafts through a drafts-enabled ActionServer (round 2
               sends round 1's tokens back: equal tokens, 1.0 verify pass a
               batch on /healthz, B4 launches = passes x 32 x 7;
               zero-draft tokens against the sequential kernel tail); then a
               w8a8 7B policy beside weight-only int8 on its weights; for
               each, prefill/tail wall ms, device busy ms, B4 launches and
               peak memory;
  5. flash   — the attention kernels B1/B2 against their plain versions on
               the card (the attack step's shape with a dummy batch's causal
               + padding bias, B=1, the verify smoke's bs 2 with its batch's
               bias, a data-parallel rank's bs 4, a ragged S, an all-zero
               bias, S=17 inside one tile, S=2048, and the benchmark cells'
               five attentions: Phi-2's head dim 80, the towers' 64 and 72
               without a bias, Mistral's 8 key/value heads), each bit-equal
               across two launches, with times, bounds and the
               scaled_dot_product_attention yardstick at the attack shape and
               the cells' shapes;
  norm    — the norm kernels (LayerNorm and RMSNorm: forward, backward and
               the weight gradients) against the plain chain's autograd at the
               benchmark cells' seven norm shapes and the 7B trainer's, each
               bit-equal across two launches, with times (each launch cold in
               L2) beside their byte bounds, the plain chain and the
               F.layer_norm / F.rms_norm yardstick;
  6. attack  — the attack slice end to end: `cli.attack` (UADA, OpenVLA-7B
               at full width and depth, bf16, random weights, dummy data)
               in-process, the B1/B2 kernels its device trace shows run and
               those launched from the host (steps 2-3 replay the step's CUDA
               graph), and the norm kernels' host launches (every norm of
               every step takes them), losses and patches; then one outer
               step's launches,
               the inner-step time, the device breakdown of a replayed outer
               step with its B1/B2 kernels and peak memory; a captured and a
               replayed outer step bit-equal to eager steps from the same
               state, for OpenVLA-7B and for the Moonlight-16B-A3B VLA at full
               width and depth; TMA (with the val and clean-filter steps) and
               UPA steps; one inner step's loss and patch gradient through
               the kernels against the plain attention and norm path;
  7. data    — the RLDS data plane: the port's writer makes 24 episodes x 16
               steps of 256x256 JPEG frames in the bridge schema under
               build/; the native C++ reader (DATA_LAYER; built against the
               vendored libjpeg headers and Pillow's libjpeg) with the data
               plane's frames/s, first batch and batch ms; a bs 8 batch
               through device_prefetch onto the card (bit-equal) and the
               runner's copy, pinned against pageable; and `cli.attack
               --dataset bridge_orig` on its batches (the same checks as the
               attack phase, plus the DATA_* lines and the statistics file);
  8. checkpoint — the 7B from a checkpoint directory: the seeded bf16 weights
               of `cli.attack --seed` written in the released OpenVLA
               layout (three safetensors shards, the index, config.json,
               dataset_statistics.json) under build/; the read rate onto the
               card; `load_policy(dir, quantize="int4")` timed to the first
               action; its bs 8 decode against an int4 policy built in
               memory from the drawn weights (prefill logits bit-equal, the
               tokens equal, 1344 B4 launches); 8 HTTP
               clients of an ActionServer over it; every converted leaf
               torch.equal to the weights drawn again; `cli.attack
               --checkpoint dir` against the seeded run (TRAIN_loss
               bit-equal, B1/B2 launches); then one forward with labels of
               the phi-2+3b zoo entry (CLIP ViT-L/336 + Phi-2, random bf16
               weights; no kernel: Phi runs the chunked attention);
  9. eval    — closed-loop LIBERO evaluation of the int4 7B loaded from that
               directory: `cli.eval_libero` in-process over replayed episodes
               (a `libero` module of the script's own: seeded 256x256 frames
               of a coherent random walk, success after 6 real steps; LIBERO
               is not installed), lockstep at bs 8 with and without Jacobi
               drafts and the reference's bs 1 loop, with a seeded 50x50
               patch; per run the control steps, the step's host frame work
               and policy call, B4 launches and verify passes per step; the
               frames that reached the policy recomputed, the JAX summary
               line and log name, and Jacobi against the sequential tokens;
 10. verify  — `cli.verify_checkpoint` on the directory (manifest, parity in
               fp32 with TF32 off against transformers modules, the TMA smoke
               with B1/B2, the int4+qk quant leg with B4), each leg's seconds,
               peak memory and launches; the smoke's first step against the
               plain attention path (loss and patch gradient) and each quant
               decode (B4 at m = 2) against the plain int4 tail on its inputs.
               The directory is deleted after it.
 11. ddp     — the data-parallel attack through torchrun: `python -m
               torch.distributed.run --nproc_per_node N -m
               roboticattack_torch.cli.attack --data_parallel true` (UADA,
               the 7B, the attack phase's schedule) at N=1 on NCCL with
               --profile, then N=2 on the one card over gloo with gspmd and
               with exact; per run the ranks' patch hashes (equal), rank 0's
               files alone, TRAIN_loss == TRAIN_mse_distance (no +1/CE), B1/B2
               and norm launches per rank, per-rank peak memory and outer-step ms
               (two processes sharing one card: no scaling measure), the
               profile's B1/B2 events, N=2's first loss against N=1's.
 12. tp      — tensor- and data-parallel serving of the int4 7B from the
               checkpoint directory (run after verify, before the directory
               is deleted), each a torchrun job of `chip_smoke.py tp-rank`
               ranks that call the CLI's main: `cli.serve --tp 2` and `--dp 2
               --tp 2` with 8 HTTP clients (then SIGINT to rank 0), and
               `cli.eval_libero --tp 4` over the eval phase's replayed
               episodes; 2-4 processes share the one card over gloo (no
               scaling measure; the eval's episodes end after 2 real
               steps). Per rank: exit 0, 1344 B4 launches a decode
               (groups of 128 at tp 2, of 64 at tp 4),
               the load peak below 12 GiB, what the rank keeps of it equal
               to its leaves as the audit gives them (parallel/evidence.py,
               meta tensors: `chip_smoke.py audits`, a process of its own
               without the card, started before this phase) up to the
               allocator's rounding, decode wall ms; the tokens against a
               single-process policy on
               the same checkpoint and group size by the margin rule of the
               eval phase. Then B4 against its plain version, timed, at each
               tp's per-rank shapes and every row count m those runs gave
               them (`phase_kernels_tp`).
 13. tp_attack — the attack step under a model axis on the 7B at full width
               and depth: make_mesh(data, model=2) -> shard_leaves of the
               seeded weights (each rank cuts every leaf as it is drawn) ->
               make_attack_step(mesh=...), one UADA and one TMA inner step
               from one fixed patch and fixed draws of a bs 8 dummy batch,
               as torchrun jobs of `chip_smoke.py tp-attack-rank` on the one
               card over gloo: tp 2 with shard_projector (2 processes) and
               dp 2 x tp 2 (4 processes; the ranks load in turn). Per rank:
               exit 0, each step's loss within 2e-3 relative of the one
               process's and its patch gradient no further from the one
               process's (1 - cosine) than twice the one process's own
               distance from the f32 gradient of the same weights and step
               (run in the phase), one patch SHA-256 across the ranks,
               64 + 3 x 49 / 32 + 49 B1 / B2 launches (decoder + towers)
               and twice those norm launches plus the final norm's,
               the collectives it recorded equal,
               as a multiset, to the audit of the same rank and step on meta
               tensors, its leaves' bytes equal to the audit's, no gather of
               1 MB, the load and step peaks beside a reckoning from the
               leaves. Then B1/B2
               at the ranks' local-head shapes [8, 16, 288, 128] and [4, 16,
               288, 128], fed as strided views: bit-equal to the kernels on
               all heads there, against the plain versions, timed.
 14. train   — the VLA trainer (`VLATrainer.run_training`, step by step) on
               the seeded bf16 7B at full width and depth with flash and
               remat, the towers frozen (the *-icy stage), fsdp on one rank,
               lr 2e-5, 4 steps on one dummy batch of 8: step 1 (lr 0)
               bit-equal, the loss falling strictly over steps 2-4, the
               towers bit-equal, 64 + 2 x 49 / 32 B1/B2 launches a step
               (the frozen towers' blocks run twice, forward only) and the
               norm kernels' (the decoder's weight gradients too), the peak
               under 76 GiB beside the reckoning from the leaves, the share
               of LLM elements step 2 changed; per step wall ms, one step's
               forward+backward and update ms and its device profile; the
               loss and eight leaves' gradients (three of norm weights)
               through the kernels against plain attention and norms; the tiny train-then-attack on the card (the
               JAX integration test's thresholds, and its int4 policies with
               int4_kernel unset where the kernel cannot run: an f32 model,
               groups of 16; the kernel off, 7 finite actions); then a
               torchrun job of
               two `chip_smoke.py train-rank` processes on the card over
               gloo (the 7B's widths with 2 LLM layers, bs 8 global, 3
               steps, ddp then fsdp): exit 0, one parameter SHA-256 across
               ranks and strategies, losses within 1e-2 of one process,
               B1/B2 and norm launches on every rank.
Then one JSON line of per-kernel numbers, the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import re
import shutil
import signal
import struct
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
from roboticattack_torch.attacks.optimizer import cosine_schedule_with_warmup
from roboticattack_torch.cli import attack as attack_cli
from roboticattack_torch.data import batch_iterator, collate, dummy_frame_iterator
from roboticattack_torch.eval.libero import LiberoEvalConfig, apply_patch_to_frame
from roboticattack_torch.eval.policy import VLAPolicy, load_policy
from roboticattack_torch.models import build_config, convert, get_config, safetensors_io
from roboticattack_torch.models.convert import LLAMA_LAYER_NAMES, VIT_BLOCK_NAMES
from roboticattack_torch.models.param_tree import tree_from_leaves, tree_leaves
from roboticattack_torch.models.vlm import init_vla_params, param_count, vla_forward
from roboticattack_torch.ops import attention as attention_ops
from roboticattack_torch.ops import flash_attention as fa
from roboticattack_torch.ops import kernel_build
from roboticattack_torch.ops import norm as norm_ops
from roboticattack_torch.ops.attention import causal_bias, padding_bias
from roboticattack_torch.ops.q4_matmul import (
    _unpack_nibbles,
    q4_matmul,
    q4_matmul_plain,
    reset_launches,
)
from roboticattack_torch.serving.http import ActionServer
from roboticattack_torch.training import TrainConfig, VLATrainer, trainable_mask
from roboticattack_torch.utils.constants import IGNORE_INDEX
from roboticattack_torch.utils.profiling import counting_collectives
from roboticattack_torch.utils.labels import build_tma_target_tokens
from roboticattack_torch.utils.normalization import dual_normalize
from roboticattack_torch.utils.prompting import WordStubTokenizer, build_vla_example
from vlabench.common.trace import reduce_events

MODEL = "openvla-7b"
MOONLIGHT = "vla-moonlight-16b-a3b"  # the sparse-expert VLA, held graphed against eager in phase_attack
SEED = 0
VT_KEEP = 128  # visual_tokens of the pruned decode: half the 7B's 256 patches
JACOBI_M = 56  # B4's rows in the Jacobi pass at bs 8: 8 rows x 7 draft positions
M_ROWS = (1, 2, 8, JACOBI_M)
M_CHECK = (JACOBI_M + 1, 64)  # B4 held without timing: a ragged last n-tile, 8 full n-tiles
GROUP = 128  # the 7B's int4 group size (models/quant.py int4_group_size_for)
# B4's groups in phase_kernels: the 7B's, a tp=4 rank's, and int4:32
GROUPS = (GROUP, 64, 32)
# (label, out, in) of the decode tail's projections; launches per layer
PROJ = [("q/k/v/o_w", 4096, 4096, 4), ("gate/up_w", 11008, 4096, 2), ("down_w", 4096, 11008, 1)]
# mode -> (name, the TPU kernel it replaces)
KERNELS = {
    "grouped": ("q4_matmul_grouped_mma", "roboticattack_tpu/ops/q4_matmul.py:70"),
    "dense": ("q4_matmul_dense_mma", "roboticattack_tpu/ops/q4_matmul.py:96"),
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
SMOKE_BS = 2  # cli.verify_checkpoint's --smoke-bs default
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
            m = re.search(r"\d+((?:flash|q4|norm)\w*?kernel)(I\w*?EE)?", ln)
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


def launch_counted(label: str, mode: str, fn):
    """fn() through the q4_matmul wrapper; raises unless it launched the
    kernel once, in `mode`, and nothing else."""
    before = dict(q4_matmul.launches)
    out = fn()
    torch.cuda.synchronize()
    if q4_matmul.launches != dict(before, **{mode: before[mode] + 1}):
        raise AssertionError(f"{label}: launches {before} -> {q4_matmul.launches}, not one {mode} launch")
    return out


def check_q4(label: str, mode: str, y, w, sc) -> float:
    """One launch of B4/B5 against the plain version (check_close), then a
    second launch on the same inputs, bit-equal to the first (the warps'
    partials are summed in a fixed order). Returns the largest error."""
    got = launch_counted(label, mode, lambda: q4_matmul(y, w, sc, mode=mode))
    err = check_close(label, got, q4_matmul_plain(y, w, sc, mode, torch.bfloat16))
    again = q4_matmul(y, w, sc, mode=mode)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    return err


def q4_bound(out_dim: int, in_dim: int, gs: int, m: int, bw: float):
    """(byte_ms, op_ms) of one launch: the packed weights, the scales and the
    activations read once and the output written once at the card's rate,
    or the products at the bf16 tensor-core peak."""
    nbytes = out_dim * in_dim // 2 + out_dim * (in_dim // gs) * 4 + m * in_dim * 2 + m * out_dim * 2
    return nbytes / bw * 1e3, 2 * m * out_dim * in_dim / PEAK_BF16_FLOPS * 1e3


def phase_kernels(bw: float):
    """Every kernel against its plain version at the 7B projection shapes,
    timed; timing cycles through enough distinct weight copies to exceed the
    50 MB L2, as the decode tail (32 layers of weights) finds them cold.
    Grouped mode (B4) with groups of 128 (the 7B's), 64 (tp 4's) and 32 at m
    = 1, 2, 8 and 56, and at m = 57 and 64 errors only; dense mode (B5) with
    groups of 128 at m = 1, 2, 8, and with groups of 32 and 64 at 4096x4096,
    m=8, errors only. Each check is also bit-equal across two launches.
    Returns the timed rows and the untimed checks."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, checked = [], []
    for label, out_dim, in_dim, per_layer in PROJ:
        nbuf = max(2, math.ceil(200e6 / (out_dim * in_dim // 2)))
        ws = [torch.randint(-128, 128, (out_dim, in_dim // 2), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.int8) for _ in range(nbuf)]
        for gs in GROUPS:
            g = in_dim // gs
            scs = [(torch.rand((out_dim, g), generator=gen, device="cuda") + 0.5) * 2e-3
                   for _ in range(nbuf)]
            dense_w = [dequant_bf16(w, s) for w, s in zip(ws[:4], scs[:4])]
            # m = 1, 2 and 8: the sequential tail's s=1 steps at bs 1 (eval), 2
            # (the verify quant leg) and 8 (serving, lockstep eval); m = 56:
            # the Jacobi pass at bs 8, y [8, 7, in] (seven n-tiles of 8)
            for m in M_ROWS:
                y = torch.randn((m // 7, 7, in_dim) if m == JACOBI_M else (m, 1, in_dim),
                                generator=gen, device="cuda").to(torch.bfloat16)
                byte_ms, op_ms = q4_bound(out_dim, in_dim, gs, m, bw)
                bound_ms = max(byte_ms, op_ms)
                library_ms = device_ms(lambda i: torch.matmul(y, dense_w[i % len(dense_w)].T))
                for mode in ("grouped", "dense") if gs == GROUP and m != JACOBI_M else ("grouped",):
                    name = f"{mode} {label} m={m} groups of {gs}"
                    err = check_q4(name, mode, y, ws[0], scs[0])

                    def kern(i):
                        return q4_matmul(y, ws[i % nbuf], scs[i % nbuf], mode=mode)

                    ms = device_ms(kern)
                    host_ms = eager_ms(kern, reps=100)
                    plain_ms = device_ms(
                        lambda i: q4_matmul_plain(y, ws[i % nbuf], scs[i % nbuf], mode, torch.bfloat16),
                        calls=4, replays=3)
                    gbps = (byte_ms * 1e-3 * bw) / (ms * 1e-3) / 1e9
                    row = dict(mode=mode, group=gs, shape=label, out=out_dim, inp=in_dim, m=m,
                               per_layer=per_layer, max_abs_err=err, ms=ms, host_ms=host_ms,
                               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                               byte_ms=byte_ms, op_ms=op_ms,
                               bound_by="bytes" if byte_ms >= op_ms else "operations", gbps=gbps)
                    rows.append(row)
                    log(f"kernel {KERNELS[mode][0]} {label} [{out_dim}x{in_dim}] m={m}, groups of {gs}: "
                        f"max_abs_err={err:.3g} (tol 2^-7 x max|plain|; two launches bit-equal) "
                        f"kernel_ms={ms:.5f} eager_back_to_back_ms={host_ms:.5f} "
                        f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                        f"(torch.matmul on a pre-dequantized bf16 weight: reads 4x the bytes) "
                        f"bound_ms={bound_ms:.5f} ({row['bound_by']}) achieved={gbps:.0f} GB/s")
            # a ragged last n-tile and 8 full ones: errors only
            for m in M_CHECK:
                y = torch.randn((m, 1, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
                name = f"grouped {label} m={m} groups of {gs}"
                err = check_q4(name, "grouped", y, ws[0], scs[0])
                checked.append(dict(mode="grouped", group=gs, shape=label, m=m, max_abs_err=err))
                log(f"kernel {KERNELS['grouped'][0]} {name}: max_abs_err={err:.3g} (tol 2^-7 x max|plain|; "
                    f"two launches bit-equal)")
            del scs, dense_w
        del ws
        torch.cuda.empty_cache()
    # dense mode with groups of 32 and 64: 4 and 2 scales a row a k-block
    for gs in (32, 64):
        w = torch.randint(-128, 128, (4096, 2048), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        sc = (torch.rand((4096, 4096 // gs), generator=gen, device="cuda") + 0.5) * 2e-3
        y = torch.randn((8, 1, 4096), generator=gen, device="cuda").to(torch.bfloat16)
        name = f"dense [4096x4096] m=8 groups of {gs}"
        err = check_q4(name, "dense", y, w, sc)
        checked.append(dict(mode="dense", group=gs, shape="q/k/v/o_w", m=8, max_abs_err=err))
        log(f"kernel {KERNELS['dense'][0]} {name}: max_abs_err={err:.3g} (tol 2^-7 x max|plain|; "
            f"two launches bit-equal)")
    return rows, checked


# tp -> (the int4 group size at that tp, B4's per-rank shapes (label, out,
# in, launches a layer) of the 7B's Megatron split: q/k/v/gate/up split out,
# o/down split the contraction). At tp 4, 11008 / 4 = 2752 is not a multiple
# of 128: groups of 64 (models/quant.py int4_group_size_for).
TP_SHAPES = {
    2: (128, [("q/k/v_w", 2048, 4096, 3), ("o_w", 4096, 2048, 1), ("gate/up_w", 5504, 4096, 2),
              ("down_w", 4096, 5504, 1)]),
    4: (64, [("q/k/v_w", 1024, 4096, 3), ("o_w", 4096, 1024, 1), ("gate/up_w", 2752, 4096, 2),
             ("down_w", 4096, 2752, 1)]),
}


def phase_kernels_tp(bw: float, rows_by_tp: dict) -> dict:
    """B4 (grouped) against its plain version at each rank's shapes of the
    7B under tensor parallelism (TP_SHAPES), at every row count m that the
    tp runs gave those shapes (`rows_by_tp`: tp -> the m a rank's decodes
    ran), each check bit-equal across two launches, timed as phase_kernels
    times, with the byte bound and the library yardstick: per tp and m, one
    layer's 7 launches summed; per tp, the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for tp, ms in sorted(rows_by_tp.items()):
        gs, shapes = TP_SHAPES[tp]
        by_m = {m: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "byte_ms": 0.0, "op_ms": 0.0, "library_ms": 0.0}
                for m in ms}
        err_max = 0.0
        for label, out_dim, in_dim, per_layer in shapes:
            g = in_dim // gs
            nbuf = max(2, math.ceil(200e6 / (out_dim * in_dim // 2)))
            ws = [torch.randint(-128, 128, (out_dim, in_dim // 2), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(nbuf)]
            scs = [(torch.rand((out_dim, g), generator=gen, device="cuda") + 0.5) * 2e-3 for _ in range(nbuf)]
            dense_w = [dequant_bf16(w, sc) for w, sc in zip(ws[:4], scs[:4])]
            for m in ms:
                y = torch.randn((m, 1, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
                name = f"tp {tp} {label} [{out_dim}x{in_dim}] m={m}, groups of {gs}"
                err = check_q4(name, "grouped", y, ws[0], scs[0])
                byte_ms, op_ms = q4_bound(out_dim, in_dim, gs, m, bw)
                ms_k = device_ms(lambda i: q4_matmul(y, ws[i % nbuf], scs[i % nbuf]))
                plain_ms = device_ms(lambda i: q4_matmul_plain(y, ws[i % nbuf], scs[i % nbuf], "grouped",
                                                               torch.bfloat16), calls=4, replays=3)
                library_ms = device_ms(lambda i: torch.matmul(y, dense_w[i % len(dense_w)].T))
                for k, v in (("ms", ms_k), ("plain_ms", plain_ms), ("bound_ms", max(byte_ms, op_ms)),
                             ("byte_ms", byte_ms), ("op_ms", op_ms), ("library_ms", library_ms)):
                    by_m[m][k] += v * per_layer
                err_max = max(err_max, err)
                log(f"kernel {KERNELS['grouped'][0]} {name}: max_abs_err={err:.3g} (tol 2^-7 x max|plain|; two "
                    f"launches bit-equal) kernel_ms={ms_k:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                    f"bound_ms={max(byte_ms, op_ms):.5f} achieved={byte_ms * 1e-3 * bw / (ms_k * 1e-3) / 1e9:.0f} GB/s")
            del ws, scs, dense_w
            torch.cuda.empty_cache()
        for m, tot in by_m.items():
            tot["bound_by"] = "bytes" if tot["byte_ms"] >= tot["op_ms"] else "operations"
            log(f"kernel {KERNELS['grouped'][0]} at a tp={tp} rank's shapes (groups of {gs}), one layer's 7 "
                f"launches at m={m}: kernel {tot['ms']:.5f} ms, plain {tot['plain_ms']:.5f} ms, library "
                f"{tot['library_ms']:.5f} ms, bound {tot['bound_ms']:.5f} ms ({tot['bound_by']})")
        out[tp] = dict(group=gs, max_abs_err=err_max, by_m=by_m)
    return out


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
    # the benchmark's reduction: device work only, without the spans' shadows
    # on the device timeline (user annotations) or runtime markers
    try:
        trace = reduce_events(prof.events(), wall_ms / 1e3)
    except RuntimeError:  # no device activity recorded
        log(f"{label}: device busy share: not measured (the profiler recorded no device time)")
        return {m: "not measured" for m in (*match, "busy")}
    busy_ms = trace.busy_s * 1e3
    found = {m: sum(t for name, (_, t) in trace.by_name.items() if m in name) * 1e3 for m in match}
    log(f"{label}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall (unprofiled) -> "
        f"device busy share {busy_ms / wall_ms:.3f}; "
        + "; ".join(f"{m} kernels {v:.2f} ms" for m, v in found.items()) + f" [{card}]")
    for name, (n, t) in sorted(trace.by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"{label}:   device {t * 1e3:8.3f} ms  x{n:<6d} {name[:100]}")
    return dict(found, busy=busy_ms)


def device_breakdown(policy, frames, tasks, num_steps: int, wall_ms: float, card: str,
                     label: str = "slice", top: int = 10, **options) -> dict:
    """The device breakdown of one decode of `num_steps` tokens (1 = the
    prefill alone), with the policy's decode options overridden by
    `options`."""
    return device_profile(decode_call(policy, frames, tasks, num_steps, **options), wall_ms,
                          f"{label}: bs={len(frames)} decode of {num_steps} token(s)", card,
                          match=("q4_matmul",), top=top)


def tail_drift(kern, plain) -> tuple:
    """The kernel tail's logits against the plain int4 tail's of the same
    batch, at the tail positions whose fed tokens agree so far (where they
    are comparable): (relative error per position, largest |difference|)."""
    tk, tp = kern.tokens.cpu().numpy(), plain.tokens.cpu().numpy()
    rel, drift = [], 0.0
    for b in range(tk.shape[0]):
        for i in range(1, tk.shape[1]):
            if not np.array_equal(tk[b, :i], tp[b, :i]):
                break
            lk, lp = kern.logits[b, i].float(), plain.logits[b, i].float()
            rel.append(((lk - lp).norm() / lp.norm()).item())
            drift = max(drift, (lk - lp).abs().max().item())
    return rel, drift


# The plain int4 tail rounds every dequantized weight to bf16 (2^-9 relative)
# where the kernel contracts the exact s4 integers in f32 and scales the f32
# group sums; over 32 layers x 7 projections x 6 steps that drifts the logits
# by a few 1e-2 relative (PERF.md). 0.1 leaves room and still catches a wrong
# kernel (O(1) error).
TAIL_LOGITS_TOL = 0.1


def check_tail_against_plain(label: str, kern, plain) -> dict:
    """A decode's kernel tail (B4) against the plain int4 tail of the same
    batch: the first token and the prefill logits equal, the tail logits
    within TAIL_LOGITS_TOL relative where the fed tokens agree. Returns the
    token agreement on positions 1-6, the largest relative error and the
    largest |logit difference| (the drift)."""
    tk, tp = kern.tokens.cpu().numpy(), plain.tokens.cpu().numpy()
    first_ok = np.array_equal(tk[:, 0], tp[:, 0])
    prefill_logits_equal = torch.equal(kern.logits[:, 0], plain.logits[:, 0])
    agree = float((tk[:, 1:] == tp[:, 1:]).mean())
    rel, drift = tail_drift(kern, plain)
    rel_max = max(rel) if rel else float("nan")
    log(f"{label}: kernel tail vs plain int4 tail on the same batch (bs {tk.shape[0]}): first token equal "
        f"{first_ok} (prefill logits bit-equal {prefill_logits_equal}); token agreement "
        f"on positions 1-6 {agree:.3f}; tail logits max rel err {rel_max:.4g} over "
        f"{len(rel)} positions (tol {TAIL_LOGITS_TOL}), max abs difference {drift:.4g}")
    if not (first_ok and prefill_logits_equal):
        raise AssertionError(f"{label}: first token differs between the kernel and plain int4 paths")
    if not rel or not rel_max <= TAIL_LOGITS_TOL:
        raise AssertionError(f"{label}: tail logits rel err {rel_max} > {TAIL_LOGITS_TOL}")
    return {"agree": agree, "rel_max": rel_max, "drift": drift}


def phase_slice(card: str) -> dict:
    t = time.perf_counter()
    policy = load_policy(None, MODEL, quantize="int4", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    cfg = policy.cfg
    steps, layers = 6, cfg.llm.num_layers
    per_decode = steps * layers * 7
    # the towers' 2 norms a block, then the decoder's 2 a layer and its final norm over the prefill and each step
    norms_per_decode = 2 * tower_blocks(cfg) + (steps + 1) * (2 * layers + 1)
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
        norm_ops.reset_launches()
        t = time.perf_counter()
        try:
            concurrent_posts(url, frames, tasks)
        finally:
            serve_s = time.perf_counter() - t
            launches = dict(q4_matmul.launches)  # read right after the main path
            norms = dict(norm_ops.launches)
        decodes = server.batcher.stats["batches"] - batches_before
        bucket_counts = server.batcher.bucket_counts()
    finally:
        server.shutdown()
    log(f"slice: {N_REQUESTS} concurrent POST /act answered 200 with 7 finite actions each "
        f"in {serve_s:.3f} s over {decodes} decode call(s) (buckets {bucket_counts})")
    log(f"slice: q4_matmul launches in the served run {launches}; expected "
        f"{per_decode} grouped per decode call ({steps} steps x {layers} layers x 7) x {decodes}")
    want_norm = {"fwd": norms_per_decode * decodes, "bwd": 0, "wgrad": 0}
    log(f"slice: norm kernels launched in the served run {norms}; expected {want_norm} ({norms_per_decode} a "
        f"decode call: 2 x {tower_blocks(cfg)} tower blocks + {steps + 1} passes (the prefill and {steps} steps) "
        f"x (2 x {layers} layers + the final norm))")
    if launches != {"grouped": per_decode * decodes, "dense": 0} or decodes < 1:
        raise AssertionError(f"launch count {launches} != {per_decode} x {decodes} grouped")
    if norms != want_norm:
        raise AssertionError(f"served run's norm launch count {norms} != {want_norm}")

    # the same batch through the kernel tail and through the plain int4 tail
    kern = policy.decode(frames, tasks)
    drift = check_tail_against_plain("slice", kern, policy.decode(frames, tasks, int4_kernel=False))["drift"]

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
    return {"launches": launches, "norm_launches": norms, "timings": timings, "peak_gib": peak,
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
    launches and peak memory."""
    from roboticattack_torch.eval.policy import VLAPolicy

    policy, frames, tasks, base = sl["policy"], sl["frames"], sl["tasks"], sl["base"]
    cfg = policy.cfg
    bs, per_pass = len(frames), cfg.llm.num_layers * 7
    total = 1 + cfg.num_patches + policy.prompt_pad - 1 + 7  # prefix slots + 7 decode slots
    base_tok = base.tokens.cpu().numpy()
    rows = {}

    def run_option(label, pol, want_b4=None, **opts):
        """One bs=8 decode with `opts` (B4 launches and peak memory over
        it), then prefill and whole-decode wall times and the device
        breakdown of the whole decode."""
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = decode_call(pol, frames, tasks, 7, **opts)()
        b4 = q4_matmul.launches["grouped"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        acts = res.actions.cpu().numpy()
        if acts.shape != (bs, 7) or not np.all(np.isfinite(acts)):
            raise AssertionError(f"{label}: actions {acts.shape} not 7 finite a row")
        if want_b4 is not None and b4 != want_b4(res):
            raise AssertionError(f"{label}: B4 launches {b4}, expected {want_b4(res)}")
        pre, tail, full = timed_decode(pol, frames, tasks, **opts)
        busy = device_breakdown(pol, frames, tasks, 7, full, card, label=f"options {label}", top=3,
                                **opts)["busy"]
        row = dict(prefill_ms=pre, tail_ms=tail, total_ms=full, busy_ms=busy, b4=b4,
                   peak_gib=peak, resident_gib=resident, passes=res.verify_passes)
        rows[label] = row
        log(f"options: {label} bs={bs}: prefill_ms={pre:.2f} tail_ms={tail:.2f} "
            f"total_ms={full:.2f} device_busy_ms={busy if isinstance(busy, str) else f'{busy:.2f}'} "
            f"verify_passes={res.verify_passes} B4 launches {b4} peak {peak:.2f} GiB "
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
        l1 = q4_matmul.launches["grouped"]
        h1 = get_json(base_url + "/healthz")["verify_passes"]
        reset_launches()
        r2 = concurrent_posts(base_url + "/act", frames, tasks, drafts=[r["tokens"] for r in r1])
        l2 = q4_matmul.launches["grouped"]  # read right after the main path
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
    if l1 != p1 * per_pass or l2 != p2 * per_pass:
        raise AssertionError(f"B4 launches {l1}, {l2} != passes x {per_pass}")
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


def tower_blocks(cfg) -> int:
    """B1 launches of one pass of the vision towers: one a block on the card
    in bf16 (ops.attention.attend hands their heads of 64 and 72 to B1/B2),
    none off it (plain attention there). Under an attack step with
    per-block recomputation the towers run 3 passes an inner step (the
    forward, the vision encode's recomputation, each block's own) and
    launch one B2 a block; the trainer's frozen towers 2 passes a step and
    no B2."""
    if torch.device(DEVICE).type != "cuda" or cfg.dtype != "bfloat16":
        return 0
    return cfg.dino.tap_layer + (cfg.siglip.tap_layer if cfg.siglip is not None else 0)


def host_launches(calls: int, inner: int, per_inner: dict) -> dict:
    """The B1/B2 launches that the kernels' wrappers make from the host over
    `calls` outer steps of one attack step function at one batch shape on
    the card, `per_inner` being one eager inner step's: the first call runs
    its `inner` inner steps eager, the second captures one inner step into
    the step's CUDA graph (attacks/graphed.py), and a replay launches
    nothing from the host. Off the card every inner step runs eager."""
    if torch.device(DEVICE).type != "cuda":
        return {k: v * inner * calls for k, v in per_inner.items()}
    return {k: v * (inner * min(calls, 1) + (calls >= 2)) for k, v in per_inner.items()}


def norm_want(b1b2: dict, forwards: int, backwards: int, trained: bool = False) -> dict:
    """The norm kernels' host launches (ops.norm.launches) on OpenVLA-7B
    beside its B1/B2 host launches `b1b2`: each of its blocks, tower and
    decoder, holds 2 norms and launches one B1 a run and one B2 a backward,
    and each of the `forwards` decoder forwards runs the final norm once
    more, `backwards` of them differentiated. The attack's norm weights
    take no gradient (no weight-gradient launch); the trainer's (`trained`)
    take one at each norm its backward reaches. Off the card the plain
    norms run and launch nothing."""
    if torch.device(DEVICE).type != "cuda":
        return {"fwd": 0, "bwd": 0, "wgrad": 0}
    bwd = 2 * b1b2["bwd"] + backwards
    return {"fwd": 2 * b1b2["fwd"] + forwards, "bwd": bwd, "wgrad": bwd if trained else 0}


# B1's kernel, and B2's rows and columns kernels (one each a B2 launch), by
# the start of their names in a device trace
B1B2_KERNELS = ("flash_fwd_kernel<", "flash_bwd_rows_kernel<", "flash_bwd_cols_kernel<")


def b1b2_kernel_runs(launches: dict) -> dict:
    """The B1/B2 kernels a device trace shows for `launches`, by name."""
    return dict(zip(B1B2_KERNELS, (launches["fwd"], launches["bwd"], launches["bwd"])))


# the norm kernels' forward, backward and the weight gradients' two passes
NORM_KERNELS = ("norm_fwd_kernel<", "norm_bwd_kernel<", "norm_wgrad_part_kernel<", "norm_wgrad_sum_kernel")


def norm_kernel_runs(launches: dict) -> dict:
    """The norm kernels a device trace shows for ops.norm.launches
    `launches`, by name."""
    return dict(zip(NORM_KERNELS, (launches["fwd"], launches["bwd"], launches["wgrad"], launches["wgrad"])))


def device_kernel_runs(prof, words) -> dict:
    """How many kernels whose names contain each of `words` a profiler saw
    run on the device (a CUDA graph's replay included)."""
    runs = dict.fromkeys(words, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for w in words:
                runs[w] += w in e.name
    return runs


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


def attention_bounds(b: int, h: int, s: int, d: int, bw: float, hkv=None, bias: bool = True) -> dict:
    """Least times of B1 and B2 at q [b, h, s, d] with k/v [b, hkv, s, d]
    (hkv = h without grouped heads), with or without the [b, s, s] bias:
    each input read once, each output written once, over the memory rate;
    the products' operations over the bf16 tensor-core peak (the inputs are
    bf16)."""
    qb = b * h * s * d * 2  # q, o, dO, dq
    kvb = b * (h if hkv is None else hkv) * s * d * 2  # k, v, dk, dv
    biasb = b * s * s * 4 if bias else 0
    stats = 2 * b * h * s * 4  # the row max and sum of exp
    out = {}
    for kind, nbytes, flops in (("fwd", 2 * qb + 2 * kvb + biasb + stats, 4 * s * s * d * b * h),
                                ("bwd", 3 * qb + 4 * kvb + biasb + stats, 10 * s * s * d * b * h)):
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


def flash_timing(shape, q, k, v, bias, do, stat_m, stat_l, bw: float, card: str) -> dict:
    """B1 and B2 at `shape` (q's) timed as every kernel here (CUDA-graph
    replay), beside their plain versions, their byte / operation bounds and
    the scaled_dot_product_attention yardstick (the bias as a bf16 additive
    mask, grouped heads by enable_gqa; for B2 its forward+backward minus its
    forward)."""
    hkv = k.shape[1]
    bounds = attention_bounds(*shape, bw, hkv=hkv, bias=bias is not None)
    mask = None if bias is None else bias[:, None].to(torch.bfloat16)
    gqa = hkv != q.shape[1]
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def lib_fwd_bwd(_):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=gqa)
        torch.autograd.grad(out, (qg, kg, vg), do)

    # device time, as the kernels': eager timing of the backward reads
    # the host's autograd launch path whenever the host is slow
    lib_fwd = device_ms(lambda _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=gqa))
    lib_both = device_ms(lib_fwd_bwd)
    timing = {
        "fwd": dict(ms=device_ms(lambda _: fa.flash_attention_fwd(q, k, v, bias)),
                    plain_ms=device_ms(lambda _: fa.flash_attention_fwd_plain(q, k, v, bias),
                                       calls=4, replays=3),
                    library_ms=lib_fwd, **bounds["fwd"]),
        "bwd": dict(ms=device_ms(lambda _: fa.flash_attention_bwd(q, k, v, bias, do, stat_m, stat_l)),
                    plain_ms=device_ms(lambda _: fa.flash_attention_bwd_plain(q, k, v, bias, do),
                                       calls=4, replays=3),
                    library_ms=lib_both - lib_fwd, **bounds["bwd"]),
    }
    for kind, t in timing.items():
        log(f"flash: {FLASH_KERNELS[kind][0]} {list(shape)}{f' kv heads {hkv}' if gqa else ''}"
            f"{'' if bias is not None else ' no bias'}: kernel_ms={t['ms']:.5f} "
            f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
            f"(scaled_dot_product_attention{' with a bf16 additive mask' if bias is not None else ''}"
            f"{'' if kind == 'fwd' else ', forward+backward minus forward'}; CUDA-graph replay) "
            f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}: {t['bytes'] / 1e6:.2f} MB -> "
            f"{t['byte_ms']:.5f} ms, {t['flops'] / 1e9:.2f} GFLOP -> {t['op_ms']:.5f} ms) "
            f"achieved {t['flops'] / (t['ms'] * 1e-3) / 1e12:.2f} TFLOP/s [{card}]")
    return timing


# the benchmark cells' attentions (vlabench/): label, (b, hq, s, d), hkv, with the decoder's bias
CELL_ATTENTION = [
    ("phi-2 decoder", (8, 32, 608, 80), 32, True),
    ("CLIP ViT-L/14 at 336 px", (8, 16, 577, 64), 16, False),
    ("DINOv2 ViT-L/14 with registers", (8, 16, 261, 64), 16, False),
    ("SigLIP so400m/14", (8, 16, 256, 72), 16, False),
    ("Mistral-7B decoder, 8 kv heads", (8, 32, 288, 128), 8, True),
]


def cell_bias(b: int, s: int) -> torch.Tensor:
    """A decoder's f32 [B, S, S] causal + padding bias: row r's last 3 r
    keys padded, as the benchmark's prompts padded to 32 leave them."""
    mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
    for r in range(b):
        if 3 * r:
            mask[r, s - 3 * r:] = 0
    return (causal_bias(s, s, device="cuda") + padding_bias(mask))[:, 0].contiguous()


def phase_flash(bw: float, card: str) -> dict:
    """B1 and B2 against their plain versions on the card; times at the
    7B attack step's shape and at each benchmark cell's attention shape."""
    cfg = get_config(MODEL)
    h, d = cfg.llm.num_heads, cfg.llm.head_dim
    s = cfg.num_patches + PAD_TO
    bias8 = slice_bias(next(dummy_batches(ATTACK_BS)), cfg.num_patches)
    # the verify smoke's batch: bs 2, the same dummy frames and padding
    bias2 = slice_bias(next(dummy_batches(SMOKE_BS)), cfg.num_patches)

    def causal(b, n):
        return causal_bias(n, n, device="cuda")[:, 0].expand(b, n, n).contiguous()

    cases = [  # label, q/k/v shape, kv heads, bias, timed
        ("attack shape, dummy-batch bias", (ATTACK_BS, h, s, d), h, bias8, True),
        ("B=1", (1, h, s, d), h, bias8[:1].contiguous(), False),
        ("verify smoke shape, its batch's bias", (SMOKE_BS, h, s, d), h, bias2, False),
        ("a data-parallel rank's rows (bs 4 of 8), their bias", (ATTACK_BS // 2, h, s, d), h,
         bias8[: ATTACK_BS // 2].contiguous(), False),
        ("ragged S=100", (2, 8, 100, d), 8, causal(2, 100), False),
        ("all-zero bias", (2, 8, 128, d), 8, torch.zeros((2, 128, 128), device="cuda"), False),
        ("S=17, inside one tile", (2, 8, 17, d), 8, causal(2, 17), False),
        ("S=2048 = MAX_SEQ", (1, 4, fa.MAX_SEQ, d), 4, causal(1, fa.MAX_SEQ), False),
    ] + [(f"cell: {label}", shape, hkv, cell_bias(shape[0], shape[2]) if with_bias else None, True)
         for label, shape, hkv, with_bias in CELL_ATTENTION]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    timing, cells = {}, {}
    for label, shape, hkv, bias, timed in cases:
        b, hq, n, hd = shape
        q, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, n, hd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        o, m, l = fa.flash_attention_fwd(q, k, v, bias)
        grads = fa.flash_attention_bwd(q, k, v, bias, do, m, l)
        again = (*fa.flash_attention_fwd(q, k, v, bias), *fa.flash_attention_bwd(q, k, v, bias, do, m, l))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((o, m, l, *grads), again))
        if not same:
            raise AssertionError(f"flash {label}: two launches on the same inputs differ")
        e_fwd = check_close(f"B1 {label}", o, fa.flash_attention_fwd_plain(q, k, v, bias))
        e_bwd = max(check_close(f"B2 {label} d{nm}", g, w) for nm, g, w in
                    zip("qkv", grads, fa.flash_attention_bwd_plain(q, k, v, bias, do)))
        errs["fwd"], errs["bwd"] = max(errs["fwd"], e_fwd), max(errs["bwd"], e_bwd)
        log(f"flash: {label} {list(shape)} kv heads {hkv}{'' if bias is not None else ', no bias'}: "
            f"B1 max_abs_err={e_fwd:.4g}, B2 max_abs_err={e_bwd:.4g} (tol 2^-7 x max|plain| each; two launches "
            f"bit-equal)")
        if not timed:
            continue
        t = flash_timing(shape, q, k, v, bias, do, m, l, bw, card)
        if timing:
            cells[label] = {"shape": list(shape), "kv_heads": hkv, "bias": bias is not None,
                            "errs": {"fwd": e_fwd, "bwd": e_bwd}, "timing": t}
        else:
            timing = t
        del q, k, v, do, o, m, l, grads, again
        torch.cuda.empty_cache()
    return {"timing": timing, "errs": errs, "cells": cells}


# the benchmark cells' norms (vlabench/): label, LayerNorm or RMSNorm, [rows, width] at bs 8
CELL_NORMS = [
    ("DINOv2 ViT-L/14 with registers", "layer", (2088, 1024)),
    ("SigLIP so400m/14", "layer", (2048, 1152)),
    ("CLIP ViT-L/14 at 336 px", "layer", (4616, 1024)),
    ("phi-2 decoder", "layer", (4864, 2560)),
    ("Mistral-7B decoder", "rms", (2304, 4096)),
    ("Moonlight-16B-A3B decoder", "rms", (2304, 2048)),
    ("Moonlight-16B-A3B MLA kv_norm", "rms", (2304, 512)),
]
NORM_EPS = 1e-5
L2_BYTES = 50 * 2**20  # the H100's L2


def norm_bounds(rows: int, n: int, layer: bool, bw: float) -> dict:
    """Least times of the norm kernels at [rows, n] bf16: the forward reads x
    and the weights and writes y and the row statistics, the backward reads
    x, dy, the weight and the statistics and writes dx; each byte once, over
    the memory rate."""
    stats = rows * 4 * (2 if layer else 1)
    out = {}
    for kind, nbytes in (("fwd", 4 * rows * n + 2 * n * (2 if layer else 1) + stats),
                         ("bwd", 6 * rows * n + 2 * n + stats)):
        out[kind] = dict(bytes=nbytes, bound_ms=nbytes / bw * 1e3, bound_by="bytes")
    return out


def cold_ms(fn, inputs: list) -> float:
    """device_ms of fn(*inputs[i % len(inputs)]) over the i-th call, each
    call's output held until the graph is timed: with enough input copies
    every launch reads, and writes, memory that the launches between have
    pushed out of L2, as a launch in the step does."""
    held = []
    ms = device_ms(lambda i: held.append(fn(*inputs[i % len(inputs)])))
    held.clear()
    return ms


def phase_norm(bw: float, card: str) -> dict:
    """The norm kernels against their plain versions on the card at each
    benchmark cell's norm shape and the 7B trainer's: y, dx, and (the
    weights requiring grad, as the trainer's do) dweight and dbias within
    2^-7 x max|plain| of the plain chain's autograd; two launches of each
    bit-equal. Timed in CUDA-graph replay over enough copies of the inputs
    that each launch reads HBM, not L2, beside their byte bounds, the plain
    chain and one library call (F.layer_norm / F.rms_norm, which the port
    never calls; backward = forward + backward minus forward)."""
    cfg = get_config(MODEL)
    trainer = (TRAIN_BS * (cfg.num_patches + next(dummy_batches(TRAIN_BS)).input_ids.shape[1]), cfg.llm.hidden_size)
    shapes = list(CELL_NORMS)
    if trainer not in [shape for _, kind, shape in shapes if kind == "rms"]:
        shapes.append(("OpenVLA-7B trainer decoder", "rms", trainer))
    log(f"norm: the 7B trainer's decoder norms are RMSNorms on {list(trainer)} (bs {TRAIN_BS}); weight "
        f"gradients checked at every shape")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for label, kind, (rows, n) in shapes:
        layer = kind == "layer"
        bounds = norm_bounds(rows, n, layer, bw)
        copies = min(20, max(2, math.ceil(3 * L2_BYTES / bounds["fwd"]["bytes"])))
        xs, dys = ([torch.randn((rows, n), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(copies)]
                   for _ in range(2))
        x, dy = xs[0], dys[0]
        w = (1.0 + 0.2 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.2 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16) if layer else None
        plain = ((lambda t: norm_ops.layer_norm_plain(t, w, b, NORM_EPS)) if layer
                 else (lambda t: norm_ops.rms_norm_plain(t, w, NORM_EPS)))
        library = ((lambda t: F.layer_norm(t, (n,), w, b, NORM_EPS)) if layer
                   else (lambda t: F.rms_norm(t, (n,), w, NORM_EPS)))
        runs = []
        for _ in range(2):
            y, mean, rstd = norm_ops.norm_fwd(x, w, b, NORM_EPS)
            runs.append((y, mean, rstd, norm_ops.norm_bwd(x, dy, w, mean, rstd),
                         *norm_ops.norm_wgrad(x, dy, mean, rstd)))
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(*runs) if p is not None):
            raise AssertionError(f"norm {label}: two launches on the same inputs differ")
        y, _, _, dx, dw, db = runs[0]
        leaves = [t.detach().requires_grad_() for t in (x, w, b) if t is not None]
        y_plain = (norm_ops.layer_norm_plain(*leaves, NORM_EPS) if layer
                   else norm_ops.rms_norm_plain(*leaves, NORM_EPS))
        grads_plain = torch.autograd.grad(y_plain, leaves, dy)
        errs = {"fwd": check_close(f"norm fwd {label}", y, y_plain),
                "bwd": check_close(f"norm bwd {label}", dx, grads_plain[0]),
                "dweight": check_close(f"norm dweight {label}", dw, grads_plain[1])}
        if layer:
            errs["dbias"] = check_close(f"norm dbias {label}", db, grads_plain[2])

        def fwd_bwd(fn):
            def run(xi, dyi):
                t = xi.detach().requires_grad_()
                return torch.autograd.grad(fn(t), t, dyi)
            return run

        pairs = list(zip(xs, dys))
        plain_fwd, lib_fwd = cold_ms(lambda xi, _: plain(xi), pairs), cold_ms(lambda xi, _: library(xi), pairs)
        mean, rstd = runs[0][1:3]
        timing = {
            "fwd": dict(ms=cold_ms(lambda xi, _: norm_ops.norm_fwd(xi, w, b, NORM_EPS), pairs), plain_ms=plain_fwd,
                        library_ms=lib_fwd, **bounds["fwd"]),
            "bwd": dict(ms=cold_ms(lambda xi, dyi: norm_ops.norm_bwd(xi, dyi, w, mean, rstd), pairs),
                        plain_ms=cold_ms(fwd_bwd(plain), pairs) - plain_fwd,
                        library_ms=cold_ms(fwd_bwd(library), pairs) - lib_fwd, **bounds["bwd"]),
        }
        for way, t in timing.items():
            log(f"norm: {label} {kind} [{rows}, {n}] {way}: kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
                f"library_ms={t['library_ms']:.5f} ({'F.layer_norm' if layer else 'F.rms_norm'}"
                f"{'' if way == 'fwd' else ', forward+backward minus forward'}; CUDA-graph replay over {copies} "
                f"input copies, cold in L2) bound_ms={t['bound_ms']:.5f} ({t['bytes'] / 1e6:.2f} MB) "
                f"x{t['ms'] / t['bound_ms']:.2f} of the bound, max_abs_err={errs[way]:.4g} (tol 2^-7 x max|plain|; "
                f"two launches bit-equal) [{card}]")
        dbias = f", dbias max_abs_err={errs['dbias']:.4g}" if layer else ""
        log(f"norm: {label} {kind} [{rows}, {n}] weight gradients: dweight max_abs_err={errs['dweight']:.4g}{dbias} "
            f"(tol 2^-7 x max|plain| each, against the plain chain's autograd; two launches bit-equal)")
        out[label] = {"kind": kind, "shape": [rows, n], "errs": errs, "timing": timing, "copies": copies}
        del xs, dys, x, dy, y, dx, runs, leaves, y_plain, grads_plain, pairs
        torch.cuda.empty_cache()
    return out


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


@contextlib.contextmanager
def plain_blocks():
    """Every attention and norm of the blocks through plain PyTorch: the
    dispatches' kernel tests (ops.attention.takes_kernels,
    ops.norm.takes_kernel) answer no, so a config with attn_impl "xla" runs
    ops.attention.mha and the plain norm chains in the towers and the
    decoder."""
    saved = attention_ops.takes_kernels, norm_ops.takes_kernel
    attention_ops.takes_kernels = norm_ops.takes_kernel = lambda *a: False
    try:
        yield
    finally:
        attention_ops.takes_kernels, norm_ops.takes_kernel = saved


def step_against_plain(label: str, spec, cfg, params, patch, batch, labels, draws) -> tuple:
    """One inner step's loss and patch gradient through the kernels (B1/B2
    and the norms, towers and decoder) against the plain path
    (attn_impl="xla" under plain_blocks: plain attention and norms) on the
    same inputs: the loss within 1e-2 relative, the gradient's cosine at
    least 0.99. Returns (relative loss difference, cosine)."""
    xla_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"))
    loss_f, _, grad_f = engine.patch_loss_and_grad(spec, cfg, params, patch, batch, labels, draws)
    with plain_blocks():
        loss_x, _, grad_x = engine.patch_loss_and_grad(spec, xla_cfg, params, patch, batch, labels, draws)
    rel = abs(loss_f.item() - loss_x.item()) / abs(loss_x.item())
    cos = F.cosine_similarity(grad_f.flatten(), grad_x.flatten(), dim=0).item()
    log(f"{label}: kernel path vs plain attention and norms (attn_impl='xla'), bs {batch.images.shape[0]}: loss "
        f"{loss_f.item():.6g} vs {loss_x.item():.6g} (rel diff {rel:.3g}, tol 1e-2); patch-gradient cosine "
        f"{cos:.6f} (tol 0.99)")
    if not (rel <= 1e-2 and cos >= 0.99):
        raise AssertionError(f"{label}: kernel path disagrees with the plain path: rel {rel}, cosine {cos}")
    return rel, cos


def graphed_against_eager(label: str, spec, cfg, params, batch, draws_for) -> dict:
    """Three outer steps of one attack step function on `batch`: the first
    eager, the second captures the step's CUDA graph and replays it, the
    third replays it alone. The second and the third each against the same
    outer step, from the same state and draws, of a new step function,
    whose first call runs eager: every inner step's metrics, the patch and
    AdamW's moments bit-equal, and no B1/B2 launched from the host in the
    third. Returns the host's B1/B2 launches of the two."""
    step = engine.make_attack_step(spec, cfg, None, range(7))
    state = engine.init_attack_state(torch.Generator().manual_seed(SEED), PATCH_HW, DEVICE)
    state, _ = step(params, state, batch, 2e-3, True, draws_for(spec))
    out = {}
    for call in ("capture", "replay"):
        draws = draws_for(spec)
        fa.reset_launches()
        got, metrics = step(params, state, batch, 2e-3, True, draws)
        torch.cuda.synchronize()
        out[call] = dict(fa.flash_attention.launches)  # read right after the graphed step
        want, eager = engine.make_attack_step(spec, cfg, None, range(7))(params, state, batch, 2e-3, True, draws)
        pairs = {"patch": (got.patch, want.patch), "m": (got.opt.m, want.opt.m), "v": (got.opt.v, want.opt.v),
                 **{k: (metrics[k], eager[k]) for k in eager}}
        differ = sorted(k for k, (a, b) in pairs.items() if not torch.equal(a, b))
        log(f"{label}: the outer step that {'captures and replays' if call == 'capture' else 'replays'} the "
            f"graph against the eager step from the same state: losses {metrics['loss'].tolist()} vs "
            f"{eager['loss'].tolist()}; patch, AdamW moments and metrics bit-equal: {not differ}; B1/B2 "
            f"launched from the host {out[call]}")
        if differ:
            raise AssertionError(f"{label}: graphed {call} step differs from the eager step in {differ}")
        if call == "replay" and any(out[call].values()):
            raise AssertionError(f"{label}: a replayed step launched B1/B2 from the host: {out[call]}")
        state = got
    return out


def phase_attack(card: str) -> dict:
    """The attack slice (main path: the CLI), then direct steps."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_attack_")
    argv = ["--attack", "uada", "--model", MODEL, "--dataset", "dummy", "--iter", str(CLI_ITERS),
            "--innerLoop", str(INNER), "--bs", str(ATTACK_BS), "--pad_to", str(PAD_TO),
            "--warmup", "0", "--eval_every", str(CLI_EVAL_EVERY), "--eval_batches", "1",
            "--seed", str(SEED), "--device", DEVICE, "--output", out_dir]
    layers, towers = get_config(MODEL).llm.num_layers, tower_blocks(get_config(MODEL))
    evals = len(range(0, CLI_ITERS, CLI_EVAL_EVERY))
    per_inner = {"fwd": 2 * layers + 3 * towers, "bwd": layers + towers}
    ran_want = b1b2_kernel_runs({"fwd": CLI_ITERS * INNER * per_inner["fwd"] + evals * (layers + towers),
                                 "bwd": CLI_ITERS * INNER * per_inner["bwd"]})
    host = host_launches(CLI_ITERS, INNER, per_inner)
    want = {"fwd": host["fwd"] + evals * (layers + towers), "bwd": host["bwd"]}
    passes = host_launches(CLI_ITERS, INNER, {"n": 1})["n"]  # inner steps run from the host
    want_norm = norm_want(want, passes + evals, passes)
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # the main path's count starts here
        norm_ops.reset_launches()
        t = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            attack_cli.main(argv)
            torch.cuda.synchronize()
        launches = dict(fa.flash_attention.launches)  # read right after the main path
        norms = dict(norm_ops.launches)
        cli_s = time.perf_counter() - t
        ran = device_kernel_runs(prof, B1B2_KERNELS)
        del prof
        log(f"attack: `python -m roboticattack_torch.cli.attack {' '.join(argv[:-4])}` ran in "
            f"{cli_s:.1f} s (weight init included; under the profiler, device activity alone); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log(f"attack: B1/B2 kernels run on the device in the CLI run {ran}; expected {ran_want} "
            f"({CLI_ITERS} steps x {INNER} inner x (2 x {layers} decoder + 3 x {towers} tower B1 with remat, "
            f"{layers} + {towers} B2, two kernels each) + {evals} val forwards x ({layers} + {towers}) B1)")
        log(f"attack: B1/B2 launched from the host {launches}; expected {want} (step 1's {INNER} inner steps "
            f"eager, step 2's graph captured from one, replays launch nothing from the host; the val forwards)")
        log(f"attack: norm kernels launched from the host {norms}; expected {want_norm} (2 norms a block: twice "
            f"the B1/B2 launches, and the decoder's final norm once a forward from the host, {passes} inner steps "
            f"+ {evals} val forwards; the weights take no gradient)")
        if ran != ran_want:
            raise AssertionError(f"CLI B1/B2 kernels on the device {ran} != {ran_want}")
        if launches != want:
            raise AssertionError(f"CLI launch count {launches} != {want}")
        if norms != want_norm:
            raise AssertionError(f"CLI norm launch count {norms} != {want_norm}")
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        lines = [json.loads(ln) for ln in open(os.path.join(out_dir, "run-metrics.jsonl"))]
        losses = [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln]
        vals = [ln for ln in lines if any(k.startswith("VAL_") for k in ln)]
        if len(losses) != CLI_ITERS or not np.all(np.isfinite(losses)) or len(vals) != evals:
            raise AssertionError(f"CLI losses {losses}, {len(vals)} val lines")
        log(f"attack: TRAIN_loss per step {losses}; VAL lines {[{k: v for k, v in ln.items() if k.startswith('VAL')} for ln in vals]}")
        cli_timing = {k: v for ln in lines for k, v in ln.items() if k.startswith("TIMING_")}
        log(f"attack: the CLI run's {cli_timing} [{card}]")
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
    norm_ops.reset_launches()
    state, metrics = step(params, state, batch, 2e-3, True, draws_for(spec))
    torch.cuda.synchronize()
    one, one_norm = dict(fa.flash_attention.launches), dict(norm_ops.launches)
    want_one = {"fwd": INNER * (2 * layers + 3 * towers), "bwd": INNER * (layers + towers)}
    want_one_norm = norm_want(want_one, INNER, INNER)
    log(f"attack: one outer step (UADA, {INNER} inner) launched B1/B2 {one}; expected {want_one}; norm kernels "
        f"{one_norm}, expected {want_one_norm}")
    if one != want_one or one_norm != want_one_norm:
        raise AssertionError(f"outer-step launch count {one} != {want_one} or norms {one_norm} != {want_one_norm}")
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
    fa.reset_launches()
    norm_ops.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_step()
    replayed, replayed_norm = dict(fa.flash_attention.launches), dict(norm_ops.launches)
    ran = device_kernel_runs(prof, B1B2_KERNELS)
    norm_ran = device_kernel_runs(prof, NORM_KERNELS)
    log(f"attack: one more outer step (a replay of the step's graph) ran B1/B2 kernels {ran} on the device, "
        f"expected {b1b2_kernel_runs(want_one)}, and norm kernels {norm_ran}, expected "
        f"{norm_kernel_runs(want_one_norm)}; launched from the host B1/B2 {replayed}, norms {replayed_norm}")
    if (ran != b1b2_kernel_runs(want_one) or any(replayed.values()) or norm_ran != norm_kernel_runs(want_one_norm)
            or any(replayed_norm.values())):
        raise AssertionError(f"replayed outer step: B1/B2 kernels {ran}, norm kernels {norm_ran}, host launches "
                             f"{replayed}, {replayed_norm}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"attack: peak torch.cuda.max_memory_allocated over the UADA steps = {peak:.2f} GiB [{card}]")
    graphed = {MODEL: graphed_against_eager("attack", spec, cfg, params, batch, draws_for)}

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
    rel, cos = step_against_plain("attack", spec, cfg, params, state.patch, batch, labels,
                                  draws_for(spec, 1).inner[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the sparse-expert VLA at full width and depth, graphed against eager
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), get_config(MOONLIGHT))
    graphed[MOONLIGHT] = graphed_against_eager("attack moonlight", spec, get_config(MOONLIGHT), params, batch,
                                               draws_for)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "inner_ms": inner_ms, "device": found, "peak_gib": peak,
            "rel": rel, "cos": cos, "cli_timing": cli_timing, "cli_peak_gib": cli_peak, "want": want,
            "device_runs": ran, "graphed": graphed}


# ------------------------------------------------------------------ data
# The RLDS data plane, cut to size: 24 episodes x 16 steps of 256x256 JPEG
# frames in the bridge schema (camera image_0), written by the port's own
# writer (no TensorFlow needed); a 256-frame shuffle buffer in place of the
# reference's 100,000 (15.05 GB of 224x224 frames, and the first batch would
# wait for all of them). 24 episodes keep the 95% / 5% split of a tfrecord
# layout non-empty (it needs at least 20).
DATA_EPISODES, DATA_STEPS, DATA_FRAME, DATA_SHUFFLE = 24, 16, 256, 256
# The phase reads with the native layer, the C++ reader built against the
# port's vendored libjpeg headers and Pillow's bundled libjpeg
# (utils/libjpeg.py): the card's machine has no TensorFlow for "tfrecord".
DATA_LAYER = "native"


class NativeTrajectories:
    """The standardized trajectories of a written layout, read by the port's
    C++ reader (the native layer's own parsing and NumPy bridge transform):
    what `compute_dataset_statistics` aggregates."""

    def __init__(self, paths, image_key):
        self.paths, self.image_key = paths, image_key

    def as_numpy_iterator(self):
        from roboticattack_torch.data.native_loader import NativeRLDSReader
        from roboticattack_torch.data.native_pipeline import _episode_to_traj, np_bridge_orig_transform

        reader = NativeRLDSReader(self.paths)
        try:
            for ex in reader:
                traj = _episode_to_traj(ex, self.image_key)
                ex.close()
                yield np_bridge_orig_transform(traj)
        finally:
            reader.close()


def check_batches_equal(label: str, got, want) -> None:
    for name, a, b in zip(want._fields, got, want):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype != np.asarray(b).dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: {name} differs")


def batch_onto_the_card(first, card: str) -> dict:
    """A host batch through device_prefetch onto the card (bit-equal), and
    the host->device ms of the runner's copy, pinned against pageable."""
    from roboticattack_torch.data import device_prefetch

    placed = next(device_prefetch(iter([first]), depth=1, device=DEVICE))
    torch.cuda.synchronize()
    check_batches_equal("the batch through device_prefetch", placed, first)
    times = {"pinned": [], "pageable": []}
    for _ in range(20):
        for kind, out in times.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.batch_to_device(first, DEVICE, non_blocking=kind == "pinned")
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
    h2d = {k: float(np.median(v)) for k, v in times.items()}
    mb = sum(np.asarray(a).size * (4 if i == 0 else 8) for i, a in enumerate(first)) / 1e6
    log(f"data: a bs={ATTACK_BS} batch through device_prefetch onto the card is bit-equal to the host "
        f"batch; host->device of the batch ({mb:.2f} MB as f32 images and int64 ids, mask, labels): "
        f"pinned + non_blocking {h2d['pinned']:.3f} ms (the pinning copy included), pageable "
        f"{h2d['pageable']:.3f} ms (median of 20, in turns) [{card}]")
    return h2d


def phase_data(card: str, att: dict) -> dict:
    """The attack on real-format RLDS data: the port writes a layout, the
    data plane alone is timed, and `cli.attack --dataset bridge_orig
    --file_layer native` runs the 7B UADA attack on its batches."""
    from roboticattack_torch.data import native_loader, rlds, synthetic_shards
    from roboticattack_torch.data.native_pipeline import NativeFrameDataset, discover_tfrecords

    cfg = get_config(MODEL)
    size = cfg.dino.image_size
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_rlds")
    shutil.rmtree(root, ignore_errors=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    cores = os.cpu_count() or 1
    out = {}
    try:
        t = time.perf_counter()
        vdir = synthetic_shards.write_rlds_layout(
            root, name="bridge_orig", n_episodes=DATA_EPISODES, steps=DATA_STEPS, image_key="image_0",
            image_size=DATA_FRAME, rng=np.random.default_rng(SEED))
        out["write_s"] = time.perf_counter() - t
        out["bytes"] = sum(os.path.getsize(os.path.join(vdir, f)) for f in os.listdir(vdir))
        log(f"data: wrote {DATA_EPISODES} episodes x {DATA_STEPS} steps of {DATA_FRAME}x{DATA_FRAME} JPEG "
            f"frames (bridge schema, image_0) with the port's writer: {out['bytes']} bytes in "
            f"{out['write_s']:.2f} s ({out['bytes'] / out['write_s'] / 1e6:.2f} MB/s) [{card}]")

        t = time.perf_counter()
        lib = native_loader.build_if_needed()
        log(f"data: layer {DATA_LAYER!r}; built {os.path.relpath(lib)} from native/rlds_reader.cpp with "
            f"g++ in {time.perf_counter() - t:.2f} s against the vendored headers and "
            f"{native_loader.libjpeg.pillow_libjpeg()}; {cores} host cores")
        paths = discover_tfrecords("bridge_orig", root)
        t = time.perf_counter()
        stats = rlds.compute_dataset_statistics(NativeTrajectories(paths, "image_0"))
        stats_path = os.path.join(root, "dataset_statistics.json")
        rlds.save_reference_statistics({"bridge_orig": stats}, stats_path)
        log(f"data: statistics of the {stats['num_transitions']} transitions computed by the port in "
            f"{time.perf_counter() - t:.3f} s; q01 {np.round(stats['action']['q01'], 4).tolist()}, "
            f"q99 {np.round(stats['action']['q99'], 4).tolist()}")

        # --- the data plane alone
        torch.cuda.synchronize()
        free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
        frames_per_pass = DATA_EPISODES * (DATA_STEPS - 2)  # the bridge transform drops 2 steps
        one_pass = NativeFrameDataset(paths, "bridge_orig", stats, image_key="image_0", image_size=size,
                                      train=False).as_numpy_iterator()
        t = time.perf_counter()
        n = sum(1 for _ in one_pass)
        pass_s = time.perf_counter() - t
        if n != frames_per_pass:
            raise AssertionError(f"one pass gave {n} frames, not {frames_per_pass}")
        jpegs = [ex.bytes_at("steps/observation/image_0", i)
                 for ex in native_loader.NativeRLDSReader(paths) for i in range(DATA_STEPS)]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cores) as pool:
            list(pool.map(lambda b: native_loader.decode_jpeg_resized(b, size), jpegs[:cores]))
            t = time.perf_counter()
            list(pool.map(lambda b: native_loader.decode_jpeg_resized(b, size), jpegs))
            decode_s = time.perf_counter() - t
        out.update(frames_per_s=n / pass_s, decode_frames_per_s=len(jpegs) / decode_s)
        log(f"data: one pass of the native layer (read, parse, standardize, decode + resize "
            f"{DATA_FRAME}->{size}, normalize; NativeFrameDataset's pool of "
            f"{min(8, cores // 2) if cores > 2 else 0} threads): {n} frames in {pass_s:.3f} s = "
            f"{n / pass_s:.1f} frames/s; decode + resize alone on a pool of {cores} threads: {len(jpegs)} "
            f"frames in {decode_s:.3f} s = {len(jpegs) / decode_s:.1f} frames/s [{card}]")

        def iterators():
            return rlds.make_attack_iterators(
                "bridge_orig", ATTACK_BS, seed=SEED, data_dir=root, tokenizer=WordStubTokenizer(),
                pad_to=PAD_TO, file_layer=DATA_LAYER, stats=stats, shuffle_buffer=DATA_SHUFFLE,
                image_size=size)

        t = time.perf_counter()
        train, _ = iterators()
        first = next(train)
        out["first_batch_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(10):
            next(train)
        out["batch_ms"] = (time.perf_counter() - t) / 10 * 1e3
        del train
        check_batches_equal("the first batch built twice from one seed", next(iterators()[0]), first)
        log(f"data: first bs={ATTACK_BS} batch of make_attack_iterators (shuffle buffer {DATA_SHUFFLE}) after "
            f"{out['first_batch_s']:.3f} s; then {out['batch_ms']:.2f} ms a batch (frames_to_attack_batches: "
            f"frames, tokenize, collate); the first batch built twice from seed {SEED} is bit-equal [{card}]")
        out["h2d_ms"] = batch_onto_the_card(first, card)
        torch.cuda.synchronize()
        other = (free0 - torch.cuda.mem_get_info()[0]) - (torch.cuda.memory_reserved() - reserved0)
        log(f"data: card memory taken outside torch's allocator while the data plane ran: "
            f"{other / 2**20:.1f} MiB")
        if abs(other) > 64 * 2**20:
            raise AssertionError(f"{other / 2**20:.1f} MiB of card memory taken outside torch by the data plane")
        gc.collect()

        # --- the attack CLI on the data plane's batches
        argv = ["--attack", "uada", "--model", MODEL, "--dataset", "bridge_orig", "--data_dir", root,
                "--file_layer", DATA_LAYER, "--stats_json", stats_path, "--shuffle_buffer",
                str(DATA_SHUFFLE), "--iter", str(CLI_ITERS), "--innerLoop", str(INNER), "--bs",
                str(ATTACK_BS), "--pad_to", str(PAD_TO), "--warmup", "0", "--eval_every",
                str(CLI_EVAL_EVERY), "--eval_batches", "1", "--seed", str(SEED), "--device", DEVICE,
                "--output", out_dir]
        evals = len(range(0, CLI_ITERS, CLI_EVAL_EVERY))
        passes = host_launches(CLI_ITERS, INNER, {"n": 1})["n"]  # inner steps run from the host
        want_norm = norm_want(att["want"], passes + evals, passes)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()  # the main path's count starts here
        norm_ops.reset_launches()
        t = time.perf_counter()
        attack_cli.main(argv)
        torch.cuda.synchronize()
        out["launches"] = launches = dict(fa.flash_attention.launches)  # read right after the main path
        out["norm_launches"] = norms = dict(norm_ops.launches)
        cli_s = time.perf_counter() - t
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"data: `python -m roboticattack_torch.cli.attack {' '.join(argv[:-2])}` ran in {cli_s:.1f} s "
            f"(weight init included); B1/B2 launched from the host {launches}, expected {att['want']}; norm "
            f"kernels {norms}, expected {want_norm}; "
            f"peak allocated {out['peak_gib']:.2f} GiB (the dummy-data CLI run: {att['cli_peak_gib']:.2f} GiB) "
            f"[{card}]")
        if launches != att["want"] or norms != want_norm:
            raise AssertionError(f"RLDS CLI launch count {launches} != {att['want']} or norms {norms} != "
                                 f"{want_norm}")
        lines = [json.loads(ln) for ln in open(os.path.join(out_dir, "run-metrics.jsonl"))]
        losses = [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln]
        vals = [ln for ln in lines if any(k.startswith("VAL_") for k in ln)]
        data = [{k: v for k, v in ln.items() if k.startswith("DATA_") or k == "step"}
                for ln in lines if "DATA_frames_seen" in ln]
        if len(losses) != CLI_ITERS or not np.all(np.isfinite(losses)) or len(vals) != evals:
            raise AssertionError(f"RLDS CLI losses {losses}, {len(vals)} val lines")
        if [d["step"] for d in data] != list(range(0, CLI_ITERS, CLI_EVAL_EVERY)):
            raise AssertionError(f"RLDS CLI DATA_* lines {data}")
        with open(os.path.join(out_dir, "dataset_statistics.json")) as f:
            if json.load(f) != {"bridge_orig": stats}:
                raise AssertionError("the run dir's dataset_statistics.json differs from the statistics passed in")
        chw = torch.load(os.path.join(out_dir, "final", "patch.pt"), weights_only=True)
        init = torch.rand((*PATCH_HW, 3), generator=torch.Generator().manual_seed(SEED))
        moved = (chw.permute(1, 2, 0) - init).abs().max().item()
        if tuple(chw.shape) != (3, *PATCH_HW) or chw.min() < 0 or chw.max() > 1 or moved == 0.0:
            raise AssertionError(f"final/patch.pt: shape {tuple(chw.shape)}, range "
                                 f"[{chw.min().item()}, {chw.max().item()}], moved {moved}")
        out["timing"] = timing = {k: v for ln in lines for k, v in ln.items() if k.startswith("TIMING_")}
        dummy = att["cli_timing"]
        log(f"data: TRAIN_loss per step {losses}; VAL lines "
            f"{[{k: v for k, v in ln.items() if k.startswith('VAL')} for ln in vals]}; DATA lines {data}; "
            f"dataset_statistics.json in the run dir equals the statistics passed in; final/patch.pt in "
            f"[{chw.min().item():.4f}, {chw.max().item():.4f}], max |change| {moved:.4g}")
        log(f"data: outer step ({INNER} inner, bs {ATTACK_BS}, S = {cfg.num_patches + PAD_TO}) wall ms, RLDS "
            f"data: p50 {timing['TIMING_p50_s'] * 1e3:.2f}, min {timing['TIMING_min_s'] * 1e3:.2f}, mean "
            f"{timing['TIMING_mean_s'] * 1e3:.2f}; dummy data (phase attack, this process): p50 "
            f"{dummy['TIMING_p50_s'] * 1e3:.2f}, min {dummy['TIMING_min_s'] * 1e3:.2f}, mean "
            f"{dummy['TIMING_mean_s'] * 1e3:.2f} (TIMING_* include staging the next batch's copy) [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ checkpoint
# the dataset statistics of the exported checkpoint (one key, as a finetune's)
CKPT_STATS = {"bridge_orig": {"action": {"q01": [-0.5] * 7, "q99": [0.5] * 7,
                                         "mask": [True] * 6 + [False]}}}
CKPT_SHARDS = 3
ST_DTYPE_NAMES = {dtype: name for name, dtype in safetensors_io.DTYPES.items()}


def write_safetensors(path: str, tensors: dict) -> int:
    """Write {name: tensor} (on any device) as one safetensors file, one
    tensor at a time: the 8-byte header length, the JSON header padded to 8
    bytes, the raw little-endian bytes. Returns the bytes written."""
    header, end = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [end, end + n]}
        end += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + end


def hf_state(params: dict, cfg) -> dict:
    """The inverse of models/convert.py: a parameter tree -> the released
    OpenVLA checkpoint's {HF name: tensor}, views where they can be (torch
    [out, in] linears). Each tower also gets its dead final block (zeros)
    and final norm, and a cls tower's pos_embed a cls row of zeros: the
    converter must skip the first two and fold the third (adding zero is
    exact)."""
    sd = {}
    towers = [("dino", cfg.dino, "vision_backbone.featurizer.")]
    if cfg.siglip is not None:
        towers.append(("siglip", cfg.siglip, "vision_backbone.fused_featurizer."))
    for key, vcfg, pre in towers:
        p = params["vision"][key]
        kernel = p["patch_embed"]["kernel"]
        d, ps = kernel.shape[1], vcfg.patch_size
        sd[pre + "patch_embed.proj.weight"] = kernel.reshape(ps, ps, 3, d).permute(3, 2, 0, 1)
        if "bias" in p["patch_embed"]:
            sd[pre + "patch_embed.proj.bias"] = p["patch_embed"]["bias"]
        pos = p["pos_embed"]
        if vcfg.use_cls_token:
            pos = torch.cat([torch.zeros_like(pos[:1]), pos])
        sd[pre + "pos_embed"] = pos[None]
        if vcfg.use_cls_token:
            sd[pre + "cls_token"] = p["cls_token"][None]
        if vcfg.num_reg_tokens:
            sd[pre + "reg_token"] = p["reg_tokens"][None]
        if vcfg.pre_norm:
            sd[pre + "norm_pre.weight"] = p["norm_pre"]["scale"]
            sd[pre + "norm_pre.bias"] = p["norm_pre"]["bias"]
        blocks = p["blocks"]
        names = dict(VIT_BLOCK_NAMES)
        if vcfg.use_layerscale:
            names.update(ls1="ls1.scale_factor", ls2="ls2.scale_factor")
        for i in range(vcfg.depth):
            for k, name in names.items():
                w = blocks[k][i] if i < vcfg.tap_layer else torch.zeros_like(blocks[k][0])
                sd[f"{pre}blocks.{i}.{name}"] = w.T if k.endswith("_w") else w
        sd[pre + "norm.weight"] = torch.ones_like(blocks["ln1_scale"][0])
        sd[pre + "norm.bias"] = torch.zeros_like(blocks["ln1_bias"][0])
    for k, t in params["projector"].items():  # fc1_w -> projector.fc1.weight
        layer, kind = k.split("_")
        sd[f"projector.{layer}.{'weight' if kind == 'w' else 'bias'}"] = t.T if kind == "w" else t
    llm, pre = params["llm"], "language_model."
    sd[pre + "model.embed_tokens.weight"] = llm["embed"]
    for i in range(cfg.llm.num_layers):
        for k, name in LLAMA_LAYER_NAMES.items():
            w = llm["layers"][k][i]
            sd[f"{pre}model.layers.{i}.{name}"] = w.T if k.endswith("_w") else w
    sd[pre + "model.norm.weight"] = llm["norm"]
    sd[pre + "lm_head.weight"] = llm["lm_head"].T
    return sd


def export_checkpoint(params: dict, cfg, path: str, model_id: str, stats: dict,
                      shards: int = CKPT_SHARDS) -> int:
    """Write `params` to `path` in the released OpenVLA layout: `shards`
    `model-0000k-of-0000n.safetensors` files split by bytes,
    `model.safetensors.index.json`, `config.json` naming `model_id`, and
    `dataset_statistics.json`. Raises before writing unless the disk holds
    the tensors' bytes with a third to spare. Returns the bytes of the
    shards."""
    sd = hf_state(params, cfg)
    total = sum(t.numel() * t.element_size() for t in sd.values())
    free = shutil.disk_usage(path).free
    if free < total * 4 // 3:
        raise RuntimeError(f"{free / 1e9:.1f} GB free under {path}; the checkpoint needs "
                           f"{total / 1e9:.1f} GB with a third to spare")
    parts, seen = [{} for _ in range(shards)], 0
    for name, t in sd.items():
        parts[min(shards - 1, seen * shards // total)][name] = t
        seen += t.numel() * t.element_size()
    written, weight_map = 0, {}
    for k, part in enumerate(parts):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        written += write_safetensors(os.path.join(path, fname), part)
        weight_map.update(dict.fromkeys(part, fname))
    blobs = {
        "model.safetensors.index.json": {"metadata": {"total_size": total}, "weight_map": weight_map},
        "config.json": {"model_id": model_id, "_name_or_path": f"openvla/{model_id}"},
        "dataset_statistics.json": stats,
    }
    for fname, blob in blobs.items():
        with open(os.path.join(path, fname), "w") as f:
            json.dump(blob, f)
    return written


def check_tree_equal(got: dict, want: dict, prefix: str = "") -> int:
    """Raise unless two parameter trees have the same keys and every leaf is
    torch.equal (dtype and shape included); returns the leaf count."""
    if set(got) != set(want):
        raise AssertionError(f"{prefix or 'tree'}: keys {sorted(got)} != {sorted(want)}")
    n = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n += check_tree_equal(g, w, f"{prefix}{k}.")
        elif g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{prefix}{k}: {g.dtype} {tuple(g.shape)} differs from the "
                                 f"drawn {w.dtype} {tuple(w.shape)}")
        else:
            n += 1
    return n


def attack_losses(argv: list, out_dir: str) -> tuple:
    """`cli.attack.main(argv)` in-process: (TRAIN_loss per step, B1/B2
    launches of the run, seconds)."""
    fa.reset_launches()  # the main path's count starts here
    t = time.perf_counter()
    attack_cli.main(argv + ["--output", out_dir])
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention.launches)  # read right after the main path
    secs = time.perf_counter() - t
    lines = [json.loads(ln) for ln in open(os.path.join(out_dir, "run-metrics.jsonl"))]
    return [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln], launches, secs


def phase_checkpoint(card: str, root: str) -> dict:
    """The 7B from a checkpoint directory `root` (made empty by the caller,
    which deletes it after the eval and verify phases have read it), through
    load_policy and `cli.attack --checkpoint`, against the weights it was
    written from."""
    cfg = get_config(MODEL)
    layers = cfg.llm.num_layers
    out = {}
    torch.cuda.reset_peak_memory_stats()
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    t = time.perf_counter()
    nbytes = export_checkpoint(params, cfg, root, MODEL, CKPT_STATS)
    write_s = time.perf_counter() - t
    log(f"checkpoint: wrote {MODEL} (seeded random bf16 weights, seed {SEED}) as {CKPT_SHARDS} "
        f"shards + index + config.json + dataset_statistics.json: {nbytes} bytes in "
        f"{write_s:.2f} s ({nbytes / write_s / 1e9:.2f} GB/s, card -> host -> file) [{card}]")

    # the reference: an int4 policy built in memory from the drawn weights
    ref = VLAPolicy(params, cfg, WordStubTokenizer(), CKPT_STATS, quantize="int4", device=DEVICE)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    moved = 0
    for v in safetensors_io.read_state_dict(root).values():
        moved += v.to(DEVICE).numel() * v.element_size()
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t
    log(f"checkpoint: read every tensor of the files onto the card once: {moved} bytes in "
        f"{read_s:.2f} s = {moved / read_s / 1e9:.2f} GB/s (file map -> card; the files "
        f"were just written, so mostly from the page cache) [{card}]")

    # load as a user would: each leaf read, converted, cooked and quantized
    # before the next (the conversion alone is timed below)
    rng = np.random.default_rng(SEED)
    size = cfg.dino.image_size
    frames = rng.integers(0, 256, (N_REQUESTS, size, size, 3), dtype=np.uint8)
    tasks = [f"put the {c} cup on plate {i}" for i, c in
             enumerate(["red", "green", "blue", "yellow", "white", "black", "orange", "purple"])]
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated() / 2**30
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = load_policy(root, MODEL, quantize="int4", device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    held = torch.cuda.memory_allocated() / 2**30 - resident
    first = policy.get_action(frames[0], tasks[0])
    first_s = time.perf_counter() - t0
    log(f"checkpoint: load_policy({os.path.basename(root)}, {MODEL!r}, quantize='int4', "
        f"device='cuda') in {load_s:.2f} s (read, convert, cast, cook, int4, leaf by leaf); load start -> "
        f"first action {first_s:.2f} s; action {np.round(first, 4).tolist()}; the load's peak "
        f"{load_peak:.2f} GiB = {resident:.2f} GiB resident before it (the reference policy) + {held:.2f} GiB "
        f"the policy keeps + {load_peak - resident - held:.2f} GiB transient [{card}]")
    if not (policy.int4_kernel and np.all(np.isfinite(first))):
        raise AssertionError(f"loaded policy: int4_kernel {policy.int4_kernel}, action {first}")

    want = ref.decode(frames, tasks)
    reset_launches()  # the main path's count starts here
    got = policy.decode(frames, tasks)
    torch.cuda.synchronize()
    launches = dict(q4_matmul.launches)
    per_decode = 6 * layers * 7
    prefill_equal = torch.equal(got.logits[:, 0], want.logits[:, 0])
    tokens_equal = torch.equal(got.tokens, want.tokens)
    log(f"checkpoint: bs={N_REQUESTS} decode, loaded policy vs the in-memory int4 policy of the "
        f"drawn weights: prefill logits bit-equal {prefill_equal}, 7 tokens equal {tokens_equal}, "
        f"all logits bit-equal {torch.equal(got.logits, want.logits)}; B4 launches {launches} "
        f"(expected {per_decode} grouped = 6 steps x {layers} layers x 7)")
    if not (prefill_equal and tokens_equal):
        raise AssertionError("the loaded policy decodes differently from the drawn weights'")
    if launches != {"grouped": per_decode, "dense": 0}:
        raise AssertionError(f"B4 launches {launches} != {per_decode} grouped")
    out["decode_launches"] = launches["grouped"]
    del ref, want, got
    gc.collect()
    torch.cuda.empty_cache()

    server = ActionServer(policy, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                          max_wait_ms=500.0)
    try:
        server.start()
        host, port = server.address
        reset_launches()
        t = time.perf_counter()
        replies = concurrent_posts(f"http://{host}:{port}/act", frames, tasks)
        http_s = time.perf_counter() - t
        http_launches = dict(q4_matmul.launches)
    finally:
        server.shutdown()
    log(f"checkpoint: {len(replies)} concurrent POST /act to an ActionServer over the loaded "
        f"policy answered 200 with 7 finite actions each in {http_s:.3f} s; B4 launches "
        f"{http_launches}; first reply {np.round(replies[0]['action'], 4).tolist()}")
    out["http_launches"] = http_launches["grouped"]
    del policy, server
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    peak_serve = torch.cuda.max_memory_allocated() / 2**30
    before_check = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tree = convert.load_checkpoint_dir(root, cfg, device=DEVICE)
    torch.cuda.synchronize()
    convert2_s = time.perf_counter() - t
    drawn = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    n_leaves = check_tree_equal(tree, drawn)
    log(f"checkpoint: load_checkpoint_dir(..., device='cuda') in {convert2_s:.2f} s: all "
        f"{n_leaves} leaves torch.equal to the weights drawn again from seed {SEED}")
    del tree, drawn
    gc.collect()
    torch.cuda.empty_cache()
    peak_check = torch.cuda.max_memory_allocated() / 2**30
    peak_load = max(peak_before, peak_serve, peak_check)
    log(f"checkpoint: peak torch.cuda.max_memory_allocated over write, load, serve and the leaf "
        f"check = {peak_load:.2f} GiB: the write and the reference policy {peak_before:.2f}, the load and "
        f"serve {peak_serve:.2f}, the leaf check {peak_check:.2f} (two whole bf16 trees beside the "
        f"{before_check:.2f} GiB allocated before it) [{card}]")

    # attack from the checkpoint against the seeded run
    argv = ["--attack", "uada", "--model", MODEL, "--dataset", "dummy", "--iter", "1",
            "--innerLoop", "1", "--bs", str(ATTACK_BS), "--pad_to", str(PAD_TO), "--warmup", "0",
            "--eval_every", "1", "--eval_batches", "1", "--seed", str(SEED), "--device", DEVICE]
    towers = tower_blocks(get_config(MODEL))
    want_fa = {"fwd": 2 * layers + 3 * towers + layers + towers, "bwd": layers + towers}
    runs = {}
    for tag, extra in (("--checkpoint", ["--checkpoint", root]), ("seeded", [])):
        run_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_attack_")
        try:
            torch.cuda.reset_peak_memory_stats()
            losses, fl, secs = attack_losses(argv + extra, run_dir)
            runs[tag] = (losses, fl)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"checkpoint: attack CLI ({tag}) UADA bs {ATTACK_BS}, 1 step x 1 inner: TRAIN_loss "
            f"{losses!r} in {secs:.1f} s; B1/B2 launches {fl} (expected {want_fa}: 2 x {layers} decoder and "
            f"3 x {towers} tower B1 with remat and {layers} + {towers} B2 a inner step, {layers} + {towers} B1 "
            f"for the one val forward); "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        if fl != want_fa or len(losses) != 1 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"attack run {tag}: losses {losses}, launches {fl}")
    if runs["--checkpoint"][0] != runs["seeded"][0]:
        raise AssertionError(f"--checkpoint TRAIN_loss {runs['--checkpoint'][0]} != seeded "
                             f"{runs['seeded'][0]}")
    log("checkpoint: the --checkpoint run's TRAIN_loss is bit-equal to the seeded run's")
    out["attack_launches"] = runs["--checkpoint"][1]

    # Phi-2 on the card: the CLIP ViT-L/336 + Phi-2 zoo entry, one forward
    pcfg = build_config("phi-2+3b")
    torch.cuda.reset_peak_memory_stats()
    pparams = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), pcfg)
    rng = np.random.default_rng(SEED)
    bs, text = 2, PAD_TO
    ids = torch.as_tensor(rng.integers(3, pcfg.llm.vocab_size, (bs, text)), device=DEVICE)
    mask = torch.ones_like(ids)
    labels = ids.clone()
    labels[:, 0] = IGNORE_INDEX
    size = pcfg.dino.image_size
    pixels = torch.as_tensor(rng.standard_normal((bs, 1, size, size, 3)), dtype=torch.bfloat16,
                             device=DEVICE)
    times = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = vla_forward(pparams, pcfg, ids, mask, pixels, labels)
            ce = res.loss.item()
            times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ln_v = math.log(pcfg.llm.vocab_size)
    log(f"checkpoint: phi-2+3b ({pcfg.dino.image_size}px CLIP ViT-L + Phi-2, random bf16 weights, "
        f"{param_count(pparams) / 1e9:.3f} B params) "
        f"vla_forward with labels at bs {bs}, text {text}: CE {ce:.5f} (ln {pcfg.llm.vocab_size} = "
        f"{ln_v:.5f}); logits {tuple(res.logits.shape)}; forward ms {[round(x, 2) for x in times]} "
        f"(first, second); peak {peak:.2f} GiB [{card}]")
    if not (math.isfinite(ce) and abs(ce - ln_v) < 2.0):
        raise AssertionError(f"Phi-2 CE {ce} not finite or not near ln V = {ln_v}")
    del pparams, res
    gc.collect()
    torch.cuda.empty_cache()
    out.update(phi_ce=ce, phi_ms=times[-1], phi_peak_gib=peak)
    return out


# ------------------------------------------------------------------ eval
EVAL_REAL_STEPS = 6  # post-settle steps after which a replay episode succeeds
EVAL_TRIALS = 8  # lockstep width and trials of the bs 8 runs
EVAL_XY = (120, 160)  # libero_spatial's placement in the eval queue (eval/queue.py)
EVAL_SUITE = "libero_spatial"


def coherent_walk(rng, n: int, walk: int = 6) -> list:
    """n 256x256 frames of a bounded random walk from `rng` (a camera's
    temporal coherence), after tests/test_libero_loop.py:_coherent_frames."""
    f = rng.integers(0, 256, (256, 256, 3)).astype(np.int16)
    frames = []
    for _ in range(n):
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
        f = np.clip(f + rng.integers(-walk, walk + 1, f.shape), 0, 255)
    return frames


class ReplayLibero:
    """A `libero` package of replayed episodes in sys.modules while in use
    (LIBERO is not installed on the card's machine), after
    tests/test_libero_loop.py: one task of `suite` with one initial state
    per episode; episode i serves the frames `episodes[i]` in order and
    succeeds after `real_steps` real (post-settle) steps, never when it is
    None. Every action an env takes is appended to `actions`."""

    NAMES = ("libero", "libero.libero", "libero.libero.benchmark", "libero.libero.envs")

    def __init__(self, episodes: list, real_steps, suite: str = EVAL_SUITE):
        import types

        self.episodes, self.actions = episodes, []
        replay = self

        class Env:
            def __init__(self, *a, **k):
                self.frames, self.t, self.real = None, 0, 0

            def seed(self, s):
                pass

            def reset(self):
                self.t = self.real = 0

            def set_init_state(self, state):
                self.frames = replay.episodes[int(state[0])]
                return self.obs()

            def obs(self):
                return {"agentview_image": self.frames[min(self.t, len(self.frames) - 1)]}

            def step(self, action):
                action = np.asarray(action, np.float64)
                replay.actions.append(action)
                self.t += 1
                self.real += bool(np.any(action != [0, 0, 0, 0, 0, 0, -1]))
                return self.obs(), 0.0, real_steps is not None and self.real >= real_steps, {}

            def close(self):
                pass

        class Task:
            problem_folder, bddl_file, language, name = ("replay", "replay.bddl", "put the bowl on the plate",
                                                         "replay_task")

        class Suite:
            n_tasks = 1

            def get_task(self, i):
                return Task()

            def get_task_init_states(self, i):
                return [np.array([j]) for j in range(len(replay.episodes))]

        mods = {name: types.ModuleType(name) for name in self.NAMES}
        mods["libero.libero.benchmark"].get_benchmark_dict = lambda: {suite: Suite}
        mods["libero.libero.envs"].OffScreenRenderEnv = Env
        mods["libero.libero"].get_libero_path = lambda kind: "replay"
        mods["libero.libero"].benchmark = mods["libero.libero.benchmark"]
        mods["libero.libero"].envs = mods["libero.libero.envs"]
        mods["libero"].libero = mods["libero.libero"]
        self.mods = mods

    def __enter__(self):
        self.saved = {name: sys.modules.get(name) for name in self.NAMES}
        sys.modules.update(self.mods)
        return self

    def __exit__(self, *exc):
        for name, mod in self.saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def eval_run(root: str, argv: list, trials: int) -> dict:
    """`cli.eval_libero.main(argv)` in-process on the replay episodes, with
    the host frame work, the policy calls, B4's launches and the verify
    passes of every control step recorded; the launch counts start at 0
    just before the CLI and are read just after."""
    from roboticattack_torch.cli import eval_libero as cli
    from roboticattack_torch.eval import libero as lib

    steps, host = [], [0.0]
    real = {"libero_frame": lib.libero_frame, "apply_patch_to_frame": lib.apply_patch_to_frame,
            "get_action_multi": VLAPolicy.get_action_multi}

    def timed(name):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return real[name](*a, **k)
            finally:
                host[0] += time.perf_counter() - t
        return run

    def policy_call(self, images, tasks, draft_tokens=None):
        before = q4_matmul.launches["grouped"]
        t = time.perf_counter()
        acts = real["get_action_multi"](self, images, tasks, draft_tokens=draft_tokens)
        policy_s = time.perf_counter() - t  # the actions are on the host: the call ended
        steps.append({"images": np.array(images), "tasks": list(tasks), "actions": acts,
                      "tokens": self.last_tokens.copy(), "passes": self.last_verify_passes,
                      "host_ms": host[0] * 1e3, "policy_ms": policy_s * 1e3, "end": time.perf_counter(),
                      "b4": q4_matmul.launches["grouped"] - before})
        host[0] = 0.0
        out["policy"] = self
        return acts

    out = {"steps": steps}
    rng = np.random.default_rng(SEED)
    episodes = [coherent_walk(rng, 10 + EVAL_REAL_STEPS + 2) for _ in range(trials)]
    with ReplayLibero(episodes, EVAL_REAL_STEPS) as replay:
        lib.libero_frame, lib.apply_patch_to_frame = timed("libero_frame"), timed("apply_patch_to_frame")
        VLAPolicy.get_action_multi = policy_call
        try:
            reset_launches()  # the main path's count starts here
            t = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            out["launches"] = dict(q4_matmul.launches)  # read right after the main path
            out["seconds"] = time.perf_counter() - t
        finally:
            lib.libero_frame, lib.apply_patch_to_frame = real["libero_frame"], real["apply_patch_to_frame"]
            VLAPolicy.get_action_multi = real["get_action_multi"]
        out["episodes"], out["env_actions"] = replay.episodes, replay.actions
    ends = [st["end"] for st in steps]
    out["step_ms"] = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    return out


def check_eval_run(label: str, run: dict, out_dir: str, patch: np.ndarray, trials: int, jacobi: bool) -> None:
    """The checks of one eval run: the summary line and log name of the JAX
    format, every episode a success, finite actions, B4 on every step (a
    sequential tail 6 x 32 x 7 launches, a Jacobi step passes x 32 x 7),
    and the frames that reached the policy equal to
    apply_patch_to_frame(libero_frame(obs)) recomputed from the episodes."""
    from roboticattack_torch.eval.libero import LiberoEvalConfig, apply_patch_to_frame
    from roboticattack_torch.eval.processing import libero_frame

    layers = get_config(MODEL).llm.num_layers
    summary = open(os.path.join(out_dir, f"{EVAL_SUITE}.txt")).read()
    want = (f"success_rate/total:1.0, num_episodes/total:{trials} "
            f"position_info:0.0_0.0_0.0_{EVAL_XY[0]}_{EVAL_XY[1]} \n")
    log_name = f"EVAL-{EVAL_SUITE}--{EVAL_XY[0]}_{EVAL_XY[1]}_0_0_0.txt"
    lines = open(os.path.join(out_dir, log_name)).read().splitlines()
    if summary != want or len(lines) != trials or not all("success=True" in ln for ln in lines):
        raise AssertionError(f"{label}: summary {summary!r} (want {want!r}), log {lines}")
    acts = np.stack(run["env_actions"])
    if not np.all(np.isfinite(acts)) or len(acts) != trials * (10 + EVAL_REAL_STEPS):
        raise AssertionError(f"{label}: {len(acts)} env actions, finite {np.all(np.isfinite(acts))}")
    cfg = LiberoEvalConfig(x=EVAL_XY[0], y=EVAL_XY[1])
    per_seq = 6 * layers * 7
    for k, st in enumerate(run["steps"]):
        for j in range(trials):
            frame = apply_patch_to_frame(libero_frame(run["episodes"][j][10 + k]), patch, cfg)
            if not np.array_equal(st["images"][j], frame):
                raise AssertionError(f"{label}: step {k} row {j}: the policy's frame differs from "
                                     "apply_patch_to_frame(libero_frame(obs))")
        want_b4 = (st["passes"] if jacobi else 6) * layers * 7
        if st["b4"] != want_b4 or not np.all(np.isfinite(st["actions"])):
            raise AssertionError(f"{label}: step {k} B4 {st['b4']} (want {want_b4}), passes "
                                 f"{st['passes']}, actions {st['actions']}")
    if len(run["steps"]) != EVAL_REAL_STEPS:
        raise AssertionError(f"{label}: {len(run['steps'])} control steps, not {EVAL_REAL_STEPS}")
    if not jacobi and run["launches"] != {"grouped": EVAL_REAL_STEPS * per_seq, "dense": 0}:
        raise AssertionError(f"{label}: B4 launches {run['launches']}")


def phase_eval(card: str, root: str) -> dict:
    """Closed-loop LIBERO evaluation of the int4 7B loaded from `root`:
    `cli.eval_libero` in-process over replayed episodes, lockstep at bs 8
    with and without Jacobi drafts, and the reference's bs 1 loop."""
    from roboticattack_torch.attacks.artifacts import save_patch_pt
    from roboticattack_torch.eval.libero import MAX_STEPS_PATCHED

    out_root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    patch = np.random.default_rng(SEED).uniform(0, 1, (50, 50, 3)).astype(np.float32)
    patch_path = os.path.join(out_root, "patch.pt")
    save_patch_pt(patch, patch_path)
    base = ["--checkpoint", root, "--model", MODEL, "--quantize", "int4", "--task_suite_name", EVAL_SUITE,
            "--patchroot", patch_path, "--x", str(EVAL_XY[0]), "--y", str(EVAL_XY[1]), "--device", DEVICE]
    runs = {"jacobi": (["--batch_trials", str(EVAL_TRIALS), "--num_trials_per_task", str(EVAL_TRIALS),
                        "--jacobi", "true"], EVAL_TRIALS),
            "sequential": (["--batch_trials", str(EVAL_TRIALS), "--num_trials_per_task", str(EVAL_TRIALS),
                            "--jacobi", "false"], EVAL_TRIALS),
            "bs 1": (["--batch_trials", "1", "--num_trials_per_task", "1"], 1)}
    out, res = {}, {}
    try:
        for label, (flags, trials) in runs.items():
            out_dir = os.path.join(out_root, label.replace(" ", ""))
            torch.cuda.reset_peak_memory_stats()
            run = eval_run(root, base + flags + ["--output", out_dir], trials)
            policy = run.pop("policy")
            check_eval_run(label, run, out_dir, patch, trials, label == "jacobi")
            st = run["steps"]
            hist = {}
            for s_ in st:
                hist[s_["passes"]] = hist.get(s_["passes"], 0) + 1
            b4 = [s_["b4"] for s_ in st]
            summary = open(os.path.join(out_dir, f"{EVAL_SUITE}.txt")).read()
            res[label] = {"steps": len(st), "step_ms": float(np.median(run["step_ms"])),
                          "host_ms": float(np.median([s_["host_ms"] for s_ in st])),
                          "policy_ms": float(np.median([s_["policy_ms"] for s_ in st])),
                          "b4": run["launches"], "b4_per_step": b4, "passes": hist,
                          "seconds": run["seconds"], "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            log(f"eval: `cli.eval_libero {' '.join(flags)}` (int4 {MODEL} from the checkpoint, replayed "
                f"{EVAL_SUITE} episodes, patch 50x50 at {EVAL_XY}): {trials}/{trials} successes in "
                f"{len(st)} control steps, {run['seconds']:.1f} s with the policy load; median step "
                f"{res[label]['step_ms']:.2f} ms wall (between policy calls), of which host frame work "
                f"(libero_frame + paste, {trials} frame(s)) {res[label]['host_ms']:.2f} ms and the policy "
                f"call {res[label]['policy_ms']:.2f} ms; B4 launches {run['launches']} ({b4} a step); "
                f"verify passes a step {hist}; summary {summary!r}; peak {res[label]['peak_gib']:.2f} "
                f"GiB [{card}]")
            if label == "jacobi":
                # the sequential decode of each Jacobi step's inputs on the
                # same policy, and the drift of the kernel tail from the
                # plain int4 tail on the first step
                seq = [policy.decode(s_["images"], s_["tasks"]) for s_ in st]
                plain = policy.decode(st[0]["images"], st[0]["tasks"], int4_kernel=False)
                out["drift"] = tail_drift(seq[0], plain)[1]
                out["seq_tokens"] = [r.tokens.cpu().numpy() for r in seq]
                out["flips"] = [first_flips(r, s_["tokens"]) for r, s_ in zip(seq, st)]
                out["jacobi_tokens"] = [s_["tokens"] for s_ in st]
                del seq, plain
            if label == "sequential":
                seq_run = [s_["tokens"] for s_ in st]
            del policy, run
            gc.collect()
            torch.cuda.empty_cache()
        # the sequential run's tokens are those of the sequential decode of
        # the Jacobi run's inputs (the replay serves the same frames whatever
        # the actions); Jacobi against it, step by step: a token may differ
        # only where the sequential margin of its token over Jacobi's is
        # within 2x the kernel-vs-plain drift (the options phase's rule)
        if len(seq_run) != len(out["seq_tokens"]) or not all(
                np.array_equal(a, b) for a, b in zip(seq_run, out["seq_tokens"])):
            raise AssertionError("the sequential run's tokens differ from the sequential decode of the same frames")
        bound = 2 * out["drift"]
        flips = [f for fs in out["flips"] for f in fs]
        excused = sum(int((a != b).sum()) for a, b in zip(out["jacobi_tokens"], seq_run))
        log(f"eval: Jacobi vs sequential tokens over {len(seq_run)} steps x {EVAL_TRIALS} rows: "
            f"{excused} token(s) differ; first departures (row, position, sequential margin) {flips}; "
            f"bound 2 x drift = {bound:.4f} (kernel vs plain int4 tail, step 0)")
        if any(m > bound for _, _, m in flips):
            raise AssertionError(f"Jacobi departs from the sequential tail beyond the drift bound: {flips}")
        out["excused"] = excused
        out["runs"] = res
        log(f"eval: the summary lines and the EVAL-{EVAL_SUITE}--{EVAL_XY[0]}_{EVAL_XY[1]}_0_0_0.txt logs "
            f"have the JAX format; every action finite; every policy frame equals "
            f"apply_patch_to_frame(libero_frame(obs)); the suite's step budget {MAX_STEPS_PATCHED[EVAL_SUITE]} "
            f"(episodes end after {EVAL_REAL_STEPS} real steps here) [{card}]")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    return out


# ------------------------------------------------------------------ verify
# The parity leg's max_rel divides each difference by max(|reference|, 1e-3).
# On the seeded random weights many of the 7B's logits lie near 1e-3, and two
# correct fp32 computations of 32 layers in different orders differ there by
# ~5e-5 (on an H100: max_abs <= 4.9e-5 at logits of mean magnitude 1.02,
# max_rel 2.7e-2 / 3.2e-2 for llm / full; PERF.md): the CLI's default 2e-2 is
# set for released weights. The phase gates max_rel at 0.1 and, beside it, every
# module's max_abs at 1e-3 of its reference's mean magnitude (a wrong tensor,
# transpose or tap is off by O(1) of it).
PARITY_REL_TOL, PARITY_SCALED_TOL = 0.1, 1e-3


def smoke_step_against_plain(params, cfg, batch_size: int, patch_hw: tuple, pad_to: int, seed: int,
                             **_) -> tuple:
    """The first step of `verify.tma_smoke` with these arguments rebuilt
    (its patch, batch, draws and target labels) and held against the plain
    attention path: B1/B2 at the smoke's shapes."""
    spec = engine.AttackSpec(objective="tma", geometry=True, inner_loop=1)
    device = params["llm"]["embed"].device
    patch = engine.init_attack_state(torch.Generator().manual_seed(seed), patch_hw, device).patch
    frames = dummy_frame_iterator(WordStubTokenizer(), image_size=cfg.dino.image_size, seed=seed)
    batch = engine.batch_to_device(next(batch_iterator(frames, batch_size, pad_to=pad_to)), device)
    draws = engine.draw_step(torch.Generator().manual_seed(seed * 7919), spec, batch.images.shape,
                             patch_hw, batch.labels.shape)
    target = engine.target_tensor(build_tma_target_tokens(np.zeros(7), range(7)), device)
    labels = engine.prepare_labels(spec, batch.labels, target, range(7), draws.coin)
    return step_against_plain("verify smoke", spec, cfg, params, patch, batch, labels, draws.inner[0])


def phase_verify(card: str, root: str) -> dict:
    """`cli.verify_checkpoint` on the 7B checkpoint directory: manifest,
    parity (fp32, TF32 off, against transformers modules), the TMA smoke
    (B1/B2) and the int4+qk quant leg (B4); each leg's seconds, peak and
    launches, counted from 0 just before the leg and read just after. Then
    the smoke's first step against the plain attention path, and each of the
    quant leg's kernel decodes against the plain int4 tail on its inputs."""
    import transformers

    from roboticattack_torch.cli import verify_checkpoint as cli
    from roboticattack_torch.models import decode, verify

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_verify_")
    legs = {}
    real = {name: getattr(verify, name) for name in ("parity_report", "tma_smoke", "quant_decode_report")}

    def timed(name):
        def run(*a, **k):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            fa.reset_launches()  # the leg's counts start here
            t = time.perf_counter()
            result = real[name](*a, **k)
            torch.cuda.synchronize()
            legs[name] = {"seconds": time.perf_counter() - t,  # read right after the leg
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "b1b2": dict(fa.flash_attention.launches), "b4": dict(q4_matmul.launches)}
            if name == "tma_smoke":  # on the leg's own weights and arguments
                bound = inspect.signature(real[name]).bind(*a, **k)
                bound.apply_defaults()
                legs[name]["against_plain"] = smoke_step_against_plain(**bound.arguments)
            return result
        return run

    real_decode, kernel_decodes = decode.greedy_decode_actions, []

    def recording_decode(*a, **k):  # the quant leg's decodes through B4, kept to compare
        result = real_decode(*a, **k)
        if k.get("int4_kernel"):
            kernel_decodes.append((a, k, result))
        return result

    argv = ["--model", MODEL, "--checkpoint", root, "--steps", "manifest,parity,smoke,quant",
            "--quant-modes", "int4+qk", "--parity-rel-tol", str(PARITY_REL_TOL), "--device", DEVICE,
            "--output", out_dir]
    for name in real:
        setattr(verify, name, timed(name))
    decode.greedy_decode_actions = recording_decode
    try:
        t = time.perf_counter()
        rc = cli.main(argv)
        secs = time.perf_counter() - t
        with open(os.path.join(out_dir, "verify_report.json")) as f:
            report = json.load(f)
        patch_ok = os.path.exists(os.path.join(out_dir, "smoke", "patch.pt"))
    finally:
        for name, fn in real.items():
            setattr(verify, name, fn)
        decode.greedy_decode_actions = real_decode
        shutil.rmtree(out_dir, ignore_errors=True)
    # B4 at the quant leg's m = 2 rows against the plain int4 tail of the
    # same quantized weights and inputs
    with torch.inference_mode():
        quant_checks = [check_tail_against_plain("verify quant int4+qk", kern,
                                                 real_decode(*a, **{**k, "int4_kernel": False}))
                        for a, k, kern in kernel_decodes]
    del kernel_decodes
    gc.collect()
    torch.cuda.empty_cache()
    steps = report["steps"]
    man = steps["manifest"]
    n_rules = len(verify.expected_checkpoint_rules(get_config(MODEL)))
    log(f"verify: `cli.verify_checkpoint {' '.join(argv[:-2])}` exit {rc} in {secs:.1f} s (transformers "
        f"{transformers.__version__}); manifest {man['ok']}: {n_rules} rules, {man['n_tensors']} tensors, "
        f"{man['total_bytes']} bytes, dtypes {man['dtypes']}, {man['n_unconsumed']} unconsumed (the dead final "
        f"ViT blocks and norms) [{card}]")
    pl = legs["parity_report"]
    log("verify: parity (fp32, TF32 off, transformers reference on the card): " + "; ".join(
        f"{k} max_rel {d['max_rel']:.3e} max_abs {d['max_abs']:.3e} ok {d['ok']}" for k, d in steps["parity"].items())
        + f"; {pl['seconds']:.1f} s, peak {pl['peak_gib']:.2f} GiB [{card}]")
    sl, sm = legs["tma_smoke"], steps["smoke"]
    log(f"verify: TMA smoke (bs 2, {len(sm['losses'])} iterations, bf16): losses "
        f"{[round(x, 4) for x in sm['losses']]}, decreased {sm['decreased']}; B1/B2 launches {sl['b1b2']}; "
        f"{sl['seconds']:.1f} s, peak {sl['peak_gib']:.2f} GiB; patch artifact written {patch_ok} [{card}]")
    ql, qr = legs["quant_decode_report"], steps["quant"]["int4+qk"]
    log(f"verify: quant int4+qk against the bf16 decode (bs 2, 2 batches): {qr}; B4 launches {ql['b4']}; "
        f"{ql['seconds']:.1f} s, peak {ql['peak_gib']:.2f} GiB [{card}]")
    layers = get_config(MODEL).llm.num_layers
    iters = len(sm["losses"])
    towers = tower_blocks(get_config(MODEL))
    want_fa = host_launches(iters, 1, {"fwd": 2 * layers + 3 * towers, "bwd": layers + towers})
    if rc != 0 or not report["ok"] or not patch_ok or not man["ok"]:
        raise AssertionError(f"verify_checkpoint exit {rc}, report ok {report['ok']}")
    scaled = {k: d["max_abs"] / d["ref_scale"] for k, d in steps["parity"].items()}
    log(f"verify: parity max_abs / mean |reference| per module {scaled} (tol {PARITY_SCALED_TOL}); max_rel "
        f"gated at {PARITY_REL_TOL}")
    if len(scaled) != 5 or any(not v <= PARITY_SCALED_TOL for v in scaled.values()):
        raise AssertionError(f"parity max_abs / mean |reference| {scaled} > {PARITY_SCALED_TOL}")
    if sl["b1b2"] != want_fa or ql["b4"] != {"grouped": 2 * 6 * layers * 7, "dense": 0}:
        raise AssertionError(f"verify launches: smoke {sl['b1b2']} (want {want_fa}), quant {ql['b4']}")
    if len(quant_checks) != 2:
        raise AssertionError(f"{len(quant_checks)} int4+qk decodes held against the plain tail, not 2")
    return {"seconds": secs, "legs": legs, "smoke_launches": sl["b1b2"], "quant_launches": ql["b4"]["grouped"],
            "parity": steps["parity"], "rules": n_rules, "quant_against_plain": quant_checks}


# ------------------------------------------------------------------ ddp
# The data-parallel attack through its real entry point, torchrun over
# `cli.attack --data_parallel true`, on the attack phase's schedule. The
# machine has one card: N=1 runs NCCL, N=2 puts two processes on the one
# card over gloo (NCCL refuses two ranks a device). Their times show that
# the path works and what a rank holds, not how data parallelism scales.
DDP_RUNS = [  # label, ranks, --ddp_semantics, --profile
    ("N=1, nccl, gspmd, --profile", 1, "gspmd", True),
    ("N=2 on one card, gloo, gspmd", 2, "gspmd", False),
    ("N=2 on one card, gloo, exact", 2, "exact", False),
]
DDP_TIMEOUT_S = 300


def torchrun_attack(nproc: int, semantics: str, out_dir: str, profile_dir=None) -> tuple:
    """`python -m torch.distributed.run --nproc_per_node N -m
    roboticattack_torch.cli.attack --data_parallel true ...` in its own
    process group (killed whole on a timeout): (exit code, seconds, the
    ranks' `ddp rank` lines by rank, the output's tail)."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
            "-m", "roboticattack_torch.cli.attack", "--attack", "uada", "--model", MODEL,
            "--device", DEVICE, "--dataset", "dummy", "--iter", str(CLI_ITERS), "--innerLoop", str(INNER),
            "--bs", str(ATTACK_BS), "--pad_to", str(PAD_TO), "--warmup", "0",
            "--eval_every", str(CLI_EVAL_EVERY), "--eval_batches", "1", "--seed", str(SEED),
            "--data_parallel", "true", "--ddp_semantics", semantics, "--output", out_dir]
    if profile_dir:
        argv += ["--profile", profile_dir]
    rc, secs, out = run_job(argv, DDP_TIMEOUT_S, f"torchrun --nproc_per_node {nproc} ({semantics})")
    return rc, secs, rank_lines(out), out[-3000:]


def run_job(argv: list, timeout: float, label: str) -> tuple:
    """`argv` from the repo root in its own process group, killed whole past
    `timeout` seconds: (exit code, seconds, its output)."""
    t = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"{label} ran past {timeout} s")
    return proc.returncode, time.perf_counter() - t, out


def rank_lines(out: str, prefix: str = "ddp rank") -> dict:
    """Each rank's `<prefix> r/W: {json}` object from the ranks' shared
    output, by rank. Another rank's text may run into the line on either
    side: a print's text and its newline are separate writes."""
    ranks, decoder = {}, json.JSONDecoder()
    for m in re.finditer(prefix + r" (\d+)/(\d+): (?=\{)", out):
        ranks[int(m.group(1))] = decoder.raw_decode(out, m.end())[0]
    return ranks


def trace_kernel_counts(path: str) -> dict:
    """B1/B2 kernel events in a Chrome trace of torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    # the names are the kernels' mangled C++ symbols
    return {"fwd": sum("flash_fwd_kernel" in n for n in names),
            "bwd_rows": sum("flash_bwd_rows_kernel" in n for n in names),
            "bwd_cols": sum("flash_bwd_cols_kernel" in n for n in names),
            "kernels": len(names)}


def phase_ddp(card: str) -> dict:
    """The three torchrun runs of DDP_RUNS and their checks: exit 0, the
    ranks' patch hashes equal, writes under the run dir by rank 0 alone
    (each rank's count) and the N=1 run's set of files, finite
    TRAIN losses with TRAIN_loss == TRAIN_mse_distance (no +1/CE), B1/B2
    launches per rank as the config implies, the profile's B1/B2 events,
    and N=2's first TRAIN_loss within 1e-2 relative of N=1's."""
    log(f"ddp: the parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved before the runs")
    layers = get_config(MODEL).llm.num_layers
    evals = len(range(0, CLI_ITERS, CLI_EVAL_EVERY))
    towers = tower_blocks(get_config(MODEL))
    want = {"fwd": CLI_ITERS * INNER * (2 * layers + 3 * towers) + evals * (layers + towers),
            "bwd": CLI_ITERS * INNER * (layers + towers)}
    want_norm = norm_want(want, CLI_ITERS * INNER + evals, CLI_ITERS * INNER)
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    out, files0, losses0 = {}, None, None
    try:
        for label, nproc, semantics, profile in DDP_RUNS:
            run_dir = os.path.join(root, f"n{nproc}_{semantics}")
            trace_dir = os.path.join(root, "trace") if profile else None
            rc, secs, ranks, tail = torchrun_attack(nproc, semantics, run_dir, trace_dir)
            if rc != 0 or sorted(ranks) != list(range(nproc)):
                raise AssertionError(f"ddp {label}: exit {rc}, rank lines {sorted(ranks)}\n{tail}")
            digests = {r["patch_sha256"] for r in ranks.values()}
            lines = [json.loads(ln) for ln in open(os.path.join(run_dir, "run-metrics.jsonl"))]
            train = [ln for ln in lines if "TRAIN_loss" in ln]
            vals = [ln for ln in lines if any(k.startswith("VAL_") for k in ln)]
            losses = [ln["TRAIN_loss"] for ln in train]
            # the best-checkpoint dirs (<step>/) follow the val metric, which
            # differs between runs; every other file is the same set in each
            files = sorted(rel for d, _, fs in os.walk(run_dir) for f in fs
                           if not (rel := os.path.relpath(os.path.join(d, f), run_dir)).split(os.sep)[0].isdigit())
            launches = {r: v["flash_attention_launches"] for r, v in ranks.items()}
            norms = {r: v["norm_launches"] for r, v in ranks.items()}
            log(f"ddp: {label}: torchrun exit {rc} in {secs:.1f} s (process start and 7B init per rank "
                f"included); backend {ranks[0]['backend']}; patch sha256 by rank "
                f"{ {r: v['patch_sha256'][:16] for r, v in ranks.items()} }; TRAIN_loss {losses}; "
                f"{len(vals)} VAL lines; {len(files)} files")
            for r, v in sorted(ranks.items()):
                log(f"ddp: {label}: rank {r} on {v['device']}: outer step p50 {v['step_p50_s'] * 1e3:.2f} ms, "
                    f"mean {v['step_mean_s'] * 1e3:.2f} ms (the mean holds the waits on rank 0's file writes), "
                    f"peak allocated {v['init_peak_gib']:.2f} GiB while the weights were drawn, "
                    f"{v['run_peak_gib']:.2f} GiB over the attack, B1/B2 launches {v['flash_attention_launches']}, "
                    f"norm kernels {v['norm_launches']} (expected {want_norm})"
                    f"{' (two processes sharing one card)' if nproc > 1 else ''} [{card}]")
            if len(digests) != 1:
                raise AssertionError(f"ddp {label}: the ranks' final patches differ: {digests}")
            if (len(losses) != CLI_ITERS or len(vals) != evals or not np.all(np.isfinite(losses))
                    or any(ln["TRAIN_loss"] != ln["TRAIN_mse_distance"] for ln in train)):
                raise AssertionError(f"ddp {label}: TRAIN lines {train}, {len(vals)} VAL lines")
            if any(v != want for v in launches.values()):
                raise AssertionError(f"ddp {label}: B1/B2 launches by rank {launches} != {want} each")
            if any(v != want_norm for v in norms.values()):
                raise AssertionError(f"ddp {label}: norm launches by rank {norms} != {want_norm} each")
            # each rank counts the writes it made under the shared run dir
            writes = {r: v["writes"] for r, v in sorted(ranks.items())}
            log(f"ddp: {label}: writes under the run dir by rank {writes}")
            if not (writes[0] > 0 and all(n == 0 for r, n in writes.items() if r)):
                raise AssertionError(f"ddp {label}: writes by rank {writes}: rank 0 alone must write")
            if files0 is None:
                files0 = files
            elif files != files0:
                raise AssertionError(f"ddp {label}: run dir holds {files}, not the N=1 run's {files0}")
            res = {"seconds": secs, "losses": losses, "launches": launches, "backend": ranks[0]["backend"],
                   "step_p50_ms": {r: v["step_p50_s"] * 1e3 for r, v in ranks.items()},
                   "init_peak_gib": {r: v["init_peak_gib"] for r, v in ranks.items()},
                   "run_peak_gib": {r: v["run_peak_gib"] for r, v in ranks.items()}, "sha256": digests.pop(),
                   "writes": writes}
            if profile:
                traces = sorted(os.listdir(trace_dir))
                counts = trace_kernel_counts(os.path.join(trace_dir, "trace_rank0.json"))
                want_trace = {"fwd": INNER * (2 * layers + 3 * towers), "bwd_rows": INNER * (layers + towers),
                              "bwd_cols": INNER * (layers + towers)}
                log(f"ddp: {label}: --profile wrote {traces}; kernel events in trace_rank0.json {counts}, "
                    f"B1/B2 expected {want_trace} (step 1: {INNER} inner steps)")
                if traces != ["trace_rank0.json"] or any(counts[k] != n for k, n in want_trace.items()):
                    raise AssertionError(f"ddp {label}: profile {traces}, kernel events {counts}")
                res["trace"] = counts
            if losses0 is None:
                losses0 = losses
            elif semantics == "gspmd":
                rel = abs(losses[0] - losses0[0]) / abs(losses0[0])
                log(f"ddp: {label}: step 0 TRAIN_loss {losses[0]!r} against N=1's {losses0[0]!r}: rel diff "
                    f"{rel:.3g} (tol 1e-2; the same global batch and draws, other bf16 GEMM shapes)")
                if not rel <= 1e-2:
                    raise AssertionError(f"ddp {label}: step 0 loss {losses[0]} vs N=1's {losses0[0]}")
                res["rel_to_n1"] = rel
            out[label] = res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ------------------------------------------------------------------ tp
# Tensor- and data-parallel serving of the int4 7B from the checkpoint
# directory, each run a torchrun job of 2 or 4 processes on the one card over
# gloo (NCCL refuses two ranks on one device): a correctness run, not a
# speed one. (label, CLI, processes, flags, the single-process reference's
# quantize: groups of 128 at tp 2, of 64 at tp 4)
TP_RUNS = [
    ("cli.serve --tp 2", "serve", 2, ["--tp", "2"], "int4"),
    ("cli.serve --dp 2 --tp 2", "serve", 4, ["--dp", "2", "--tp", "2"], "int4"),
    ("cli.eval_libero --tp 4", "eval", 4, ["--tp", "4"], "int4:64"),
]
TP_TIMEOUT_S = 300
TP_LOAD_PEAK_GIB = 12.0  # under the whole bf16 7B's 14.0 GiB: a rank holding the whole model fails
TP_QUANTIZE = "int4"  # the runs' --quantize: groups of int4_group_size_for(7B, tp), 128 at tp 2, 64 at tp 4
# What a rank keeps after its load (torch.cuda.memory_allocated) exceeds its
# audited leaves' bytes by the caching allocator's rounding alone (a block is
# a multiple of 512 B, and a large one is not split when under 1 MiB would be
# left): the gap, in MiB, by tp, is held to the window predicted in PERF.md
# §6 from the ranks' rounded holdings, before the card measured it.
TP_HELD_GAP_MIB = {2: (0, 4), 4: (3, 14)}


def tp_rank_main(argv: list) -> int:
    """One rank of a tp run: `chip_smoke.py tp-rank serve|eval OUT CLI-ARGS`
    runs `cli.serve.main` / `cli.eval_libero.main` (the eval over the eval
    phase's replayed episodes); rank 0 records every policy call's frames,
    tasks, tokens and actions (and the eval's env actions) to
    OUT/calls_rank0.pt."""
    kind, out_dir, cli_argv = argv[0], argv[1], argv[2:]
    rank = int(os.environ.get("RANK", "0"))
    calls, real = [], VLAPolicy.get_action_multi

    def record(self, images, tasks, draft_tokens=None):
        acts = real(self, images, tasks, draft_tokens=draft_tokens)
        calls.append({"images": np.array(images), "tasks": list(tasks), "tokens": self.last_tokens.copy(),
                      "actions": acts, "passes": self.last_verify_passes})
        return acts

    if rank == 0:
        VLAPolicy.get_action_multi = record
    if kind == "serve":
        from roboticattack_torch.cli import serve

        serve.main(cli_argv)
        env_actions = None
    else:
        from roboticattack_torch.cli import eval_libero

        rng = np.random.default_rng(SEED)
        episodes = [coherent_walk(rng, 10 + EVAL_REAL_STEPS + 2) for _ in range(EVAL_TRIALS)]
        with ReplayLibero(episodes, EVAL_REAL_STEPS) as replay:
            eval_libero.main(cli_argv)
        env_actions = replay.actions
    if rank == 0:
        torch.save({"calls": calls, "env_actions": env_actions}, os.path.join(out_dir, "calls_rank0.pt"))
    return 0


def torchrun_tp(kind: str, nproc: int, argv: list, out_dir: str, frames=None, tasks=None) -> dict:
    """`python -m torch.distributed.run --standalone --nproc_per_node N
    chip_smoke.py tp-rank KIND OUT ARGV` in its own process group (killed
    whole past TP_TIMEOUT_S). A serve run is driven as a user would: the
    frames POSTed from concurrent clients once rank 0 serves, /healthz read,
    then Ctrl-C (SIGINT) to rank 0, whose stop releases the other ranks.
    Returns the exit code, seconds, the `serving rank` lines by rank, the
    replies, /healthz, rank 0's recorded calls and the output's tail."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           os.path.abspath(__file__), "tp-rank", kind, out_dir, *argv]
    t = time.perf_counter()
    deadline = time.monotonic() + TP_TIMEOUT_S
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")), daemon=True)
    reader.start()
    replies = health = None
    try:
        if kind == "serve":
            url = pid = None
            while (url is None or pid is None) and proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.2)
                out = "".join(lines)
                m, p = re.search(r"serving on (http://\S+)", out), re.search(r"rank 0 of \d+ \(pid (\d+)\)", out)
                url, pid = m and m.group(1), p and int(p.group(1))
            if url is None or pid is None:
                raise AssertionError(f"tp {kind} x{nproc}: rank 0 never served\n{''.join(lines)[-3000:]}")
            serve_s = time.perf_counter() - t
            t_req = time.perf_counter()
            replies = concurrent_posts(url + "/act", frames, tasks)
            req_s = time.perf_counter() - t_req
            health = get_json(url + "/healthz")
            health.update(ready_s=serve_s, requests_s=req_s)
            os.kill(pid, signal.SIGINT)
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise AssertionError(f"tp {kind} x{nproc} ran past {TP_TIMEOUT_S} s\n{''.join(lines)[-3000:]}")
    except BaseException:
        os.killpg(proc.pid, 9)
        proc.wait()
        raise
    reader.join(30)
    secs = time.perf_counter() - t
    out = "".join(lines)
    path = os.path.join(out_dir, "calls_rank0.pt")
    rec = torch.load(path, weights_only=False) if os.path.exists(path) else None
    return {"rc": proc.returncode, "seconds": secs, "ranks": rank_lines(out, "serving rank"), "replies": replies,
            "health": health, "record": rec, "tail": out[-3000:]}


def check_tokens_by_margin(label: str, ref, plain, calls: list) -> dict:
    """A run's tokens against a single-process reference decode of the same
    inputs (a DecodeResult with logits per call, from `ref(call)`): a token
    may differ only where the reference's margin of its own token over the
    run's is within 2x the largest |logit difference| of the reference's
    kernel tail from its plain int4 tail (`plain`, on the first call's
    inputs; the rule of the eval phase's Jacobi check)."""
    flips, differ, n = [], 0, 0
    drift = None
    for call in calls:
        seq = ref(call)
        if drift is None:
            drift = tail_drift(seq, plain(call))[1]
        got = np.asarray(call["tokens"])
        differ += int((seq.tokens.cpu().numpy() != got).sum())
        n += got.size
        flips += first_flips(seq, got)
    bound = 2 * drift
    log(f"tp: {label}: tokens against one process on the same checkpoint and group size: {differ} of {n} "
        f"differ; first departures (row, position, one process's margin) {flips}; bound 2 x drift = "
        f"{bound:.4f} (kernel vs plain int4 tail of the reference)")
    if any(m > bound for _, _, m in flips):
        raise AssertionError(f"tp {label}: tokens depart from one process beyond the drift bound: {flips}")
    return {"differ": differ, "tokens": n, "flips": flips, "bound": bound}


def phase_tp(card: str, root: str, audits: "Audits") -> dict:
    """The runs of TP_RUNS on the int4 7B from `root` and their checks:
    every rank exits 0; each rank's every decode launches B4 1344 times
    (6 steps x 32 layers x 7); each rank's
    load peaks below TP_LOAD_PEAK_GIB; what it keeps after the load is its
    audited leaves' bytes (parallel/evidence.py rank_params, on meta) up
    to the allocator's rounding (a gap inside TP_HELD_GAP_MIB); the
    replies (serve) are 7 finite actions and the env actions (eval) finite,
    the eval's summary and log of the JAX format; the tokens equal one
    process's on the same checkpoint and group size by the margin rule."""
    from roboticattack_torch.attacks.artifacts import save_patch_pt

    t_phase = time.perf_counter()
    llm = get_config(MODEL).llm
    layers = llm.num_layers
    per_decode = 6 * layers * 7
    stack_gib = layers * llm.intermediate_size * llm.hidden_size * 2 / 2**30  # the largest bf16 stack
    rng = np.random.default_rng(SEED + 7)
    frames = rng.integers(0, 256, (N_REQUESTS, 224, 224, 3), dtype=np.uint8)
    tasks = [f"put the {c} cup on plate {i}" for i, c in enumerate(
        ["red", "green", "blue", "yellow", "white", "black", "orange", "purple"][:N_REQUESTS])]
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    patch = np.random.default_rng(SEED).uniform(0, 1, (50, 50, 3)).astype(np.float32)
    patch_path = os.path.join(work, "patch.pt")
    save_patch_pt(patch, patch_path)
    base = ["--checkpoint", root, "--model", MODEL, "--quantize", TP_QUANTIZE, "--device", DEVICE]
    out, refs = {}, {}
    try:
        for label, kind, nproc, flags, ref_quant in TP_RUNS:
            run_dir = os.path.join(work, f"{kind}_{nproc}")
            os.makedirs(run_dir)
            if kind == "serve":
                argv = base + ["--port", "0", "--max_batch", str(MAX_BATCH), "--max_wait_ms", "500"] + flags
                run = torchrun_tp(kind, nproc, argv, run_dir, frames, tasks)
            else:
                argv = base + ["--task_suite_name", EVAL_SUITE, "--patchroot", patch_path, "--x", str(EVAL_XY[0]),
                               "--y", str(EVAL_XY[1]), "--batch_trials", str(EVAL_TRIALS), "--num_trials_per_task",
                               str(EVAL_TRIALS), "--jacobi", "false", "--output", os.path.join(run_dir, "eval")] + flags
                run = torchrun_tp(kind, nproc, argv, run_dir)
            ranks = run["ranks"]
            if run["rc"] != 0 or sorted(ranks) != list(range(nproc)) or run["record"] is None:
                raise AssertionError(f"tp {label}: exit {run['rc']}, rank lines {sorted(ranks)}\n{run['tail']}")
            for r, v in sorted(ranks.items()):
                ms = v["decode_ms"]
                log(f"tp: {label}: rank {r} on {v['device']} ({v['backend']}): load peak {v['load_peak_gib']:.2f} GiB "
                    f"= {v['load_held_gib']:.2f} GiB the rank keeps (its shard, the vision towers and projector, the "
                    f"int8 embed) + {v['load_peak_gib'] - v['load_held_gib']:.2f} GiB transient (the largest whole "
                    f"bf16 stack, gate/up/down, is {stack_gib:.2f} GiB), "
                    f"run peak {v['run_peak_gib']:.2f} GiB, {v['decodes']} decodes (rows {v['rows']}), decode wall "
                    f"ms median {np.median(ms):.2f} (min {min(ms):.2f}, max {max(ms):.2f}), B4 a decode "
                    f"{v['b4'][0]} ({nproc} processes on one card over {v['backend']}: a correctness run, "
                    f"not a speed) [{card}]")
                if any(b != per_decode for b in v["b4"]) or not v["decodes"]:
                    raise AssertionError(f"tp {label}: rank {r}'s B4 launches a decode {v['b4']}, want {per_decode}")
                if not v["load_peak_gib"] < TP_LOAD_PEAK_GIB:
                    raise AssertionError(f"tp {label}: rank {r}'s load peaked at {v['load_peak_gib']:.2f} GiB")
            if len({v["decodes"] for v in ranks.values()}) != 1:
                raise AssertionError(f"tp {label}: decodes by rank {[v['decodes'] for v in ranks.values()]}")
            audited = audits.result("decode")["ranks"]
            held = {}
            for r, v in sorted(ranks.items()):
                a = audited[f"{label}, rank {r}"]
                gap = round(v["load_held_gib"] * 2**30) - a["param_bytes"]
                lo, hi = TP_HELD_GAP_MIB[v["tp"]]
                log(f"tp: {label}: rank {r} keeps {round(v['load_held_gib'] * 2**30)} B after its load; its "
                    f"{a['leaves']} leaves audited on meta (no card): {a['param_bytes']} B; gap {gap} B "
                    f"(allowed {lo} to {hi} MiB, the allocator's rounding) [{card}]")
                if not lo * MB <= gap <= hi * MB:
                    raise AssertionError(f"tp {label}: rank {r} keeps {gap} B beyond its audited leaves, "
                                         f"outside {lo}-{hi} MiB")
                held[r] = {"audit_bytes": a["param_bytes"], "gap_bytes": gap}
            calls = run["record"]["calls"]
            res = {"seconds": run["seconds"], "decodes": ranks[0]["decodes"], "tp": ranks[0]["tp"],
                   "rows": sorted({m for v in ranks.values() for m in v["rows"]}),
                   "load_peak_gib": {r: v["load_peak_gib"] for r, v in ranks.items()},
                   "load_held_gib": {r: v["load_held_gib"] for r, v in ranks.items()},
                   "run_peak_gib": {r: v["run_peak_gib"] for r, v in ranks.items()},
                   "decode_ms": {r: float(np.median(v["decode_ms"])) for r, v in ranks.items()},
                   "b4_per_rank": {r: sum(v["b4"]) for r, v in ranks.items()}, "held_vs_audit": held}
            if ref_quant not in refs:  # one single-process reference a group size, kept for the next run
                refs.clear()
                gc.collect()
                torch.cuda.empty_cache()
                refs[ref_quant] = load_policy(root, MODEL, quantize=ref_quant, device="cuda")
            ref_policy = refs[ref_quant]
            if kind == "serve":
                h = run["health"]
                log(f"tp: {label}: torchrun exit 0 in {run['seconds']:.1f} s (ranks' start and load included; "
                    f"rank 0 served after {h['ready_s']:.1f} s), {N_REQUESTS} concurrent POST /act answered 200 with "
                    f"7 finite actions in {h['requests_s']:.3f} s; /healthz stats {h['stats']} buckets {h['buckets']}")
                if h["stats"]["requests"] != N_REQUESTS or h["stats"]["errors"]:
                    raise AssertionError(f"tp {label}: /healthz {h}")
                served = [c for c in calls if c["tasks"][0] != "warmup"]
                by_task = {t: tok for c in served for t, tok in zip(c["tasks"], c["tokens"])}
                call = {"images": frames, "tasks": tasks, "tokens": np.stack([by_task[t] for t in tasks])}
                res["tokens"] = check_tokens_by_margin(
                    label, lambda c: ref_policy.decode(c["images"], c["tasks"]),
                    lambda c: ref_policy.decode(c["images"], c["tasks"], int4_kernel=False), [call])
            else:
                out_dir = os.path.join(run_dir, "eval")
                summary = open(os.path.join(out_dir, f"{EVAL_SUITE}.txt")).read()
                want_summary = (f"success_rate/total:1.0, num_episodes/total:{EVAL_TRIALS} "
                                f"position_info:0.0_0.0_0.0_{EVAL_XY[0]}_{EVAL_XY[1]} \n")
                acts = np.stack(run["record"]["env_actions"])
                log(f"tp: {label}: torchrun exit 0 in {run['seconds']:.1f} s (ranks' start and load included), "
                    f"{len(calls)} lockstep policy calls at bs {EVAL_TRIALS}; summary {summary!r}")
                if (summary != want_summary or len(calls) != EVAL_REAL_STEPS or not np.all(np.isfinite(acts))
                        or len(acts) != EVAL_TRIALS * (10 + EVAL_REAL_STEPS)):
                    raise AssertionError(f"tp {label}: summary {summary!r}, {len(calls)} calls, {len(acts)} actions")
                res["tokens"] = check_tokens_by_margin(
                    label, lambda c: ref_policy.decode(c["images"], c["tasks"]),
                    lambda c: ref_policy.decode(c["images"], c["tasks"], int4_kernel=False), calls)
            del ref_policy
            out[label] = res
    finally:
        refs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
    log(f"tp: the phase took {time.perf_counter() - t_phase:.1f} s (the single-process references' loads and "
        f"decodes included)")
    return out


# ------------------------------------------------------------------ tp_attack
# The attack step under a model axis (make_mesh(data, model) -> shard_params
# -> make_attack_step(mesh=...)) on the 7B at full width and depth: a one
# process reference, then two torchrun jobs of `chip_smoke.py
# tp-attack-rank` on the one card over gloo (a correctness run, not a speed
# one). (label, processes, tp, dp, shard_projector): tp 2 with the projector
# cut; dp 2 x tp 2 with it whole, the projector layout of the JAX package's
# 7B program (parallel/evidence.py).
TP_ATTACK_RUNS = [
    ("tp 2, shard_projector", 2, 2, 1, True),
    ("dp 2 x tp 2", 4, 2, 2, False),
]
# each job: one UADA inner step, then one TMA inner step (the gripper dim),
# from one fixed patch and fixed draws of the global batch
TP_ATTACK_STEPS = (("uada", tuple(range(7))), ("tma", (6,)))
TP_ATTACK_LR = 2e-3
TP_ATTACK_TIMEOUT_S = 420
TP_ATTACK_LOSS_RTOL = 2e-3
# A rank's patch gradient may be no further from the f32 gradient of the
# same weights and step, in 1 - cosine, than a quarter more than the one
# process's bf16 gradient is: both round in bf16, in different orders (the
# one process's gradient is itself ~0.998 from the f32 one, so the fixed
# 0.999 between the two bf16 gradients cannot be met).
TP_ATTACK_EXACT_FACTOR = 1.25
MB = 1 << 20


def tp_attack_steps(params: dict, cfg, batch_np, mesh=None) -> list:
    """TP_ATTACK_STEPS on the global dummy batch `batch_np` (cut to this
    replica's rows under a mesh), each from the same seeded patch with its
    own seeded draws: the step (make_attack_step, apply_update False, so
    the state's buffer is the patch gradient) then its update. Per step:
    the loss, the gradient on the host, the updated patch's SHA-256, B1/B2
    launches, the collectives (with their bytes and host seconds) and the
    seconds."""
    from roboticattack_torch.parallel import patch_digest, shard_batch

    batch = engine.batch_to_device(batch_np if mesh is None else shard_batch(batch_np, mesh), DEVICE)
    lr = torch.tensor(TP_ATTACK_LR, dtype=torch.float32, device=DEVICE)
    out = []
    for i, (objective, maskidx) in enumerate(TP_ATTACK_STEPS):
        spec = engine.AttackSpec(objective=objective, inner_loop=1)
        target = build_tma_target_tokens(np.zeros(7), list(maskidx)) if objective == "tma" else None
        step = engine.make_attack_step(spec, cfg, target, list(maskidx), mesh)
        state = engine.init_attack_state(torch.Generator().manual_seed(SEED), PATCH_HW, DEVICE)
        draws = engine.draw_step(torch.Generator().manual_seed(SEED + 1 + i), spec, batch_np.images.shape,
                                 PATCH_HW, batch_np.labels.shape)
        log_ = []
        torch.cuda.synchronize()
        fa.reset_launches()  # this step's count starts here
        norm_ops.reset_launches()
        t = time.perf_counter()
        with counting_collectives(log_):
            state, metrics = step(params, state, batch, TP_ATTACK_LR, False, draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches, norms = dict(fa.flash_attention.launches), dict(norm_ops.launches)
        grad = state.grad_acc.clone()
        state, _ = engine.update_patch(spec, state, grad, lr)
        out.append({"objective": objective, "loss": float(metrics["loss"][0]), "grad": grad.cpu(),
                    "sha256": patch_digest(state.patch), "launches": launches, "norm_launches": norms,
                    "collectives": log_,
                    "seconds": secs})
    return out


def tp_attack_inventory(log: list, cfg, tp: int, dp: int, rank: int, shard_projector: bool) -> dict:
    """One inner step's collectives of a rank by kind, with the bytes a
    rank gives to one of each kind and the host seconds of all of them: the
    data group's patch and packed-sums all-reduces; the model group's
    activation sums by their [B_local, S, width] shape; its row statistics
    and argmax pairs; the largest gather in bytes. Raises on any other
    collective and on any tensor with a dim of a logits row (V / tp or V)."""
    b, d = ATTACK_BS // dp, cfg.llm.hidden_size
    vl = cfg.llm.vocab_size // tp
    d_idx, m_idx = divmod(rank, tp)
    model = tuple(d_idx * tp + i for i in range(tp))
    data = tuple(i * tp + m_idx for i in range(dp))
    kinds, nbytes, seconds, gather_max = {}, {}, {}, 0
    for c in log:
        coll, op, ranks, shape = c.name, c.op, c.ranks, list(c.shape)
        if vl in shape or cfg.llm.vocab_size in shape:
            raise AssertionError(f"tp_attack: a logits-row-sized {coll} {shape}")
        if coll == "all_gather":
            gather_max = max(gather_max, c.nbytes * tp)
        if ranks == data and coll == "all_reduce" and op == "SUM" and shape == [*PATCH_HW, 3]:
            kind = "data: patch gradient"
        elif ranks == data and coll == "all_reduce" and op == "SUM" and len(shape) == 1:
            kind = "data: packed sums"
        elif ranks == model and coll == "all_reduce" and len(shape) == 3 and shape[0] == b and op == "SUM" \
                and shape[2] in (d, cfg.vision_dim):
            kind = f"model: sum {shape}"
        elif ranks == model and coll == "all_reduce" and c.nbytes < MB:
            kind = f"model: row statistics {op}"
        elif ranks == model and coll == "all_gather" and c.nbytes * tp < MB:
            kind = "model: argmax pairs"
        else:
            raise AssertionError(f"tp_attack: an unexpected collective {coll} {op} over {ranks} {shape}")
        kinds[kind] = kinds.get(kind, 0) + 1
        nbytes[kind] = c.nbytes
        seconds[kind] = seconds.get(kind, 0.0) + c.seconds
    return {"kinds": kinds, "bytes": nbytes, "seconds": seconds, "gather_max_bytes": gather_max}


def inventory_rows(collectives) -> list:
    """A collective log as sorted JSON rows [name, op, group ranks, shape,
    dtype, count]: the multiset parallel/evidence.py's `inventory` makes."""
    from roboticattack_torch.parallel.evidence import inventory

    rows = json.loads(json.dumps([[*k, n] for k, n in inventory(collectives).items()]))
    return sorted(rows, key=json.dumps)


def audits_main(argv: list) -> int:
    """`chip_smoke.py audits OUT` (Audits starts it, without the card): the
    audit (parallel/evidence.py: meta tensors, a fake process group) of
    each rank of TP_RUNS, its decode layout's leaves (rank_params), written
    to OUT/decode.json; then of each rank and step of TP_ATTACK_RUNS, the
    step's collectives and the rank's leaf bytes, to OUT/attack.json."""
    from roboticattack_torch.parallel import evidence
    from roboticattack_torch.parallel.mesh import ServingMesh

    out_dir = argv[0]
    cfg = get_config(MODEL)

    def write(name, obj):
        tmp = os.path.join(out_dir, name + ".json.tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, os.path.join(out_dir, name + ".json"))

    t = time.perf_counter()
    decode = {}
    for label, _, nproc, flags, _ in TP_RUNS:
        tp = int(flags[flags.index("--tp") + 1])
        for r in range(nproc):
            mesh = ServingMesh(tp=tp, dp=nproc // tp, rank=r, device=evidence.META)
            params = evidence.rank_params(cfg, mesh, cooked=True, quantize=TP_QUANTIZE)
            decode[f"{label}, rank {r}"] = {"param_bytes": sum(x.numel() * x.element_size() for x in params.values()),
                                            "leaves": len(params)}
    write("decode", {"ranks": decode, "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    attack = {}
    for label, nproc, tp, dp, sp in TP_ATTACK_RUNS:
        for r in range(nproc):
            for objective, maskidx in TP_ATTACK_STEPS:
                a = evidence.audit_attack_step(cfg, dp, tp, r, batch_size=ATTACK_BS, pad_to=PAD_TO,
                                               objective=objective, inner_loop=1, shard_projector=sp,
                                               maskidx=maskidx, patch_hw=PATCH_HW, apply_update=False)
                attack[f"{label}, rank {r}, {objective}"] = {
                    "calls": inventory_rows(a.collectives),
                    "param_bytes": evidence.memory_summary(a)["param_bytes"]}
    write("attack", {"steps": attack, "seconds": time.perf_counter() - t})
    return 0


AUDIT_TIMEOUT_S = 600


class Audits:
    """`chip_smoke.py audits OUT` in a process of its own with no card
    visible (CUDA_VISIBLE_DEVICES empty), started before phase_tp: the
    audits of the tp and tp_attack ranks run on the host's cores while the
    card runs the jobs they are held against. `result(name)` waits for
    OUT/<name>.json; `close()` ends the process and removes OUT."""

    def __init__(self) -> None:
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_audits_")
        self.log_path = os.path.join(self.dir, "audits.log")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "audits", self.dir],
                                         cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
                                         stderr=subprocess.STDOUT, env=env, start_new_session=True)
        self.started = time.monotonic()

    def result(self, name: str) -> dict:
        path = os.path.join(self.dir, name + ".json")
        while not os.path.exists(path):
            failed = self.proc.poll() not in (None, 0)
            if failed or time.monotonic() - self.started > AUDIT_TIMEOUT_S:
                tail = open(self.log_path).read()[-3000:]
                raise AssertionError(f"audits: no {name}.json (exit {self.proc.poll()})\n{tail}")
            time.sleep(0.5)
        with open(path) as f:
            return json.load(f)

    def close(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def tp_attack_rank_main(argv: list) -> int:
    """One rank of a tp_attack job (`chip_smoke.py tp-attack-rank TP DP
    SHARD_PROJECTOR OUT`): make_mesh(data=DP, model=TP), its shard of the
    seeded 7B drawn and cut leaf by leaf (shard_leaves), then
    tp_attack_steps; the gradients to OUT/grads_rank<r>.pt and one
    `tp-attack rank r/W: {json}` line in one write."""
    from roboticattack_torch.models.vlm import iter_vla_params
    from roboticattack_torch.parallel import distributed, make_mesh, shard_leaves

    import torch.distributed as dist

    t_all = time.perf_counter()
    tp, dp, sp, out_dir = int(argv[0]), int(argv[1]), argv[2] == "1", argv[3]
    mesh = make_mesh(data=dp, model=tp, device=DEVICE)
    cfg = get_config(MODEL)
    rank = mesh.d * tp + mesh.m
    sizes = []

    def drawn():
        for path, leaf in iter_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg):
            sizes.append(leaf.numel())
            yield path, leaf
            del leaf  # dropped before the next leaf is drawn

    torch.cuda.reset_peak_memory_stats()
    # the ranks share one card here: they load in turn, each returning its
    # draw's transients to the card before the next rank draws
    for turn in range(tp * dp):
        if turn == rank:
            t = time.perf_counter()
            params = tree_from_leaves(shard_leaves(drawn(), mesh, shard_projector=sp))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            torch.cuda.empty_cache()
        dist.barrier()
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    keeps = torch.cuda.memory_allocated() / 2**30
    leaves_bytes = sum(x.numel() * x.element_size() for _, x in tree_leaves(params))
    leaves_gib = leaves_bytes / 2**30
    # the seeded draw of the largest stack: f32, then its bf16 cast, then the cut
    reckon = leaves_gib + max(sizes) * (4 + 2) / 2**30
    torch.cuda.reset_peak_memory_stats()
    batch_np = next(dummy_batches(ATTACK_BS))
    steps = tp_attack_steps(params, cfg, batch_np, mesh)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.save([s.pop("grad") for s in steps], os.path.join(out_dir, f"grads_rank{rank}.pt"))
    for s in steps:
        s["calls"] = inventory_rows(s["collectives"])
        s["inventory"] = tp_attack_inventory(s.pop("collectives"), cfg, tp, dp, rank, sp)
    out = {"rank": rank, "d": mesh.d, "m": mesh.m, "backend": distributed.current().backend,
           "device": str(mesh.device), "load_s": load_s, "load_peak_gib": load_peak, "keeps_gib": keeps,
           "leaves_bytes": leaves_bytes, "leaves_gib": leaves_gib, "reckon_peak_gib": reckon,
           "step_peak_gib": step_peak, "steps": steps,
           "seconds": time.perf_counter() - t_all}
    sys.stdout.write(f"tp-attack rank {rank}/{tp * dp}: {json.dumps(out)}\n")
    sys.stdout.flush()
    distributed.shutdown()
    return 0


def phase_flash_tp(bw: float, card: str) -> dict:
    """B1 and B2 at the tp_attack ranks' shapes, [8, 16, 288, 128] (tp 2)
    and [4, 16, 288, 128] (dp 2 x tp 2) with the dummy batch's bias: the
    local heads taken as strided views of a whole [B, 32, 288, 128] q/k/v
    and run through mha_flash (the model's path: contiguous copies) equal
    the kernel on all heads bit for bit on those heads, and the plain
    versions within check_close; timed with flash_timing."""
    cfg = get_config(MODEL)
    h, d = cfg.llm.num_heads, cfg.llm.head_dim
    s = cfg.num_patches + PAD_TO
    bias8 = slice_bias(next(dummy_batches(ATTACK_BS)), cfg.num_patches)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    for label, b, tp in (("tp 2", ATTACK_BS, 2), ("dp 2 x tp 2", ATTACK_BS // 2, 2)):
        bias = bias8[:b].contiguous()
        whole = [torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4)]
        heads = slice(h - h // tp, h)  # the last rank's heads
        q, k, v, do = (t[:, heads] for t in whole)  # strided views, as the model's transposes give
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = fa.mha_flash(qg, kg, vg, bias=bias[:, None])
        o.backward(do)
        o_all, m_all, l_all = fa.flash_attention_fwd(*whole[:3], bias)
        g_all = fa.flash_attention_bwd(*whole[:3], bias, whole[3].contiguous(), m_all, l_all)
        torch.cuda.synchronize()
        same = torch.equal(o, o_all[:, heads]) and all(
            torch.equal(g.grad, a[:, heads]) for g, a in zip((qg, kg, vg), g_all))
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        errs = {"fwd": check_close(f"B1 {label} local heads", o, fa.flash_attention_fwd_plain(qc, kc, vc, bias)),
                "bwd": max(check_close(f"B2 {label} local heads d{n}", g.grad, w) for n, g, w in
                           zip("qkv", (qg, kg, vg), fa.flash_attention_bwd_plain(qc, kc, vc, bias, doc)))}
        log(f"flash_tp: {label} rank's local heads {[b, h // tp, s, d]} as strided views of [{b}, {h}, {s}, {d}]: "
            f"mha_flash bit-equal to the kernels on all heads there: {same}; B1 max_abs_err={errs['fwd']:.4g}, "
            f"B2 max_abs_err={errs['bwd']:.4g} against the plain versions (tol 2^-7 x max|plain| each)")
        if not same:
            raise AssertionError(f"flash_tp {label}: local heads differ from the kernels on all heads")
        _, m, l = fa.flash_attention_fwd(qc, kc, vc, bias)
        timing = flash_timing((b, h // tp, s, d), qc, kc, vc, bias, doc, m, l, bw, card)
        out[label] = {"shape": [b, h // tp, s, d], "errs": errs, "timing": timing}
        del whole, q, k, v, do, qg, kg, vg, o, o_all, g_all
        torch.cuda.empty_cache()
    return out


def phase_tp_attack(card: str, audits: Audits) -> dict:
    """The one-process reference and the TP_ATTACK_RUNS jobs and their
    checks: every rank exits 0; per step each rank's loss within
    TP_ATTACK_LOSS_RTOL of the one process's, its patch gradient's 1 -
    cosine to the f32 gradient of the same weights and step within
    TP_ATTACK_EXACT_FACTOR x the one process's bf16 gradient's, one patch
    SHA-256 across the job's ranks, 64 / 32 B1 / B2 launches (remat), the
    collectives it recorded equal, as a multiset, to the audit of the same
    rank and step on meta (parallel/evidence.py, `audits`), every gather
    under 1 MB, its leaves' bytes equal to the audit's; each rank's load
    and step peaks beside the reckoning from its leaves.
    Logged beside them: the cosine to the one process's gradient, and the
    bytes and host seconds of each kind of collective."""
    t_phase = time.perf_counter()
    cfg = get_config(MODEL)
    layers = cfg.llm.num_layers
    batch_np = next(dummy_batches(ATTACK_BS))
    t = time.perf_counter()
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    torch.cuda.reset_peak_memory_stats()
    ref = tp_attack_steps(params, cfg, batch_np)
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    # the same weights and steps in f32 with plain attention: the gradient
    # both bf16 paths approximate, to see how far each is from it
    cfg32 = dataclasses.replace(cfg, dtype="float32", llm=dataclasses.replace(cfg.llm, attn_impl="xla"))
    params = tree_from_leaves((path, x.float()) for path, x in tree_leaves(params))
    exact = tp_attack_steps(params, cfg32, batch_np)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for r, e in zip(ref, exact):
        r["cos_exact"] = F.cosine_similarity(r["grad"].flatten().double(), e["grad"].flatten().double(), dim=0).item()
        r["rel_exact"] = abs(r["loss"] - e["loss"]) / abs(e["loss"])
        log(f"tp_attack: one process in f32 (plain attention), {e['objective']}: loss {e['loss']!r}; the bf16 "
            f"step's loss {r['rel_exact']:.3g} from it relative, its patch-gradient cosine {r['cos_exact']:.6f}")
    towers = tower_blocks(get_config(MODEL))
    want_launches = {"fwd": 2 * layers + 3 * towers, "bwd": layers + towers}
    want_norm = norm_want(want_launches, 1, 1)
    for r in ref:
        log(f"tp_attack: one process, {r['objective']} inner step: loss {r['loss']!r}, patch sha256 "
            f"{r['sha256'][:16]}, B1/B2 launches {r['launches']}, norm kernels {r['norm_launches']} (expected "
            f"{want_norm}), {r['seconds']:.2f} s")
        if r["launches"] != want_launches or r["norm_launches"] != want_norm or not np.isfinite(r["loss"]):
            raise AssertionError(f"tp_attack: the one-process step: {r['launches']}, norms {r['norm_launches']}, "
                                 f"loss {r['loss']}")
    log(f"tp_attack: the one-process references (the draw, both steps in bf16 and in f32) in "
        f"{time.perf_counter() - t:.1f} s, the bf16 steps' peak {ref_peak:.2f} GiB; the parent holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB reserved before the jobs [{card}]")
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_attack_")
    out, failed = {}, []
    try:
        for label, nproc, tp, dp, sp in TP_ATTACK_RUNS:
            out_dir = os.path.join(root, f"tp{tp}_dp{dp}")
            os.makedirs(out_dir)
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
                   os.path.abspath(__file__), "tp-attack-rank", str(tp), str(dp), str(int(sp)), out_dir]
            rc, secs, text = run_job(cmd, TP_ATTACK_TIMEOUT_S, f"tp_attack {label}")
            ranks = rank_lines(text, "tp-attack rank")
            if rc != 0 or sorted(ranks) != list(range(nproc)):
                raise AssertionError(f"tp_attack {label}: exit {rc}, rank lines {sorted(ranks)}\n{text[-3000:]}")
            log(f"tp_attack: {label}: torchrun exit {rc} in {secs:.1f} s ({nproc} processes on one card over "
                f"{ranks[0]['backend']}; process start, the leaf-by-leaf load and both steps) [{card}]")
            res = {"seconds": secs, "launches": {}, "rel": {}, "cos": {}, "cos_exact": {}, "ranks": {}}
            audited = audits.result("attack")
            for r, v in sorted(ranks.items()):
                grads = torch.load(os.path.join(out_dir, f"grads_rank{r}.pt"), weights_only=True)
                log(f"tp_attack: {label}: rank {r} (d {v['d']}, m {v['m']}) on {v['device']}: load {v['load_s']:.1f} s, "
                    f"peak {v['load_peak_gib']:.2f} GiB (keeps {v['keeps_gib']:.2f}; reckoned from the leaves: "
                    f"its slices {v['leaves_gib']:.2f} + the largest stack's f32 draw and bf16 cast = "
                    f"{v['reckon_peak_gib']:.2f}); step peak {v['step_peak_gib']:.2f} GiB; {v['seconds']:.1f} s "
                    f"in all [{card}]")
                res["ranks"][r] = {k: v[k] for k in ("load_s", "load_peak_gib", "keeps_gib", "leaves_bytes",
                                                     "leaves_gib", "reckon_peak_gib", "step_peak_gib", "seconds")}
                for s, g, want, e in zip(v["steps"], grads, ref, exact):
                    a = audited["steps"][f"{label}, rank {r}, {s['objective']}"]
                    log(f"tp_attack: {label}: rank {r} {s['objective']}: {sum(n for *_, n in s['calls'])} "
                        f"collectives recorded in {len(s['calls'])} kinds; the audit on meta (no card): equal as a "
                        f"multiset: {s['calls'] == a['calls']}; leaves {v['leaves_bytes']} B, audited "
                        f"{a['param_bytes']} B")
                    if s["calls"] != a["calls"]:
                        failed.append(f"{label} rank {r} {s['objective']}: collectives {s['calls']} != the "
                                      f"audit's {a['calls']}")
                    if v["leaves_bytes"] != a["param_bytes"]:
                        failed.append(f"{label} rank {r}: leaves {v['leaves_bytes']} B != audited "
                                      f"{a['param_bytes']} B")
                    rel = abs(s["loss"] - want["loss"]) / abs(want["loss"])
                    cos = F.cosine_similarity(g.flatten().double(), want["grad"].flatten().double(), dim=0).item()
                    cos_exact = F.cosine_similarity(g.flatten().double(), e["grad"].flatten().double(), dim=0).item()
                    bound = TP_ATTACK_EXACT_FACTOR * (1.0 - want["cos_exact"])
                    inv = s["inventory"]
                    colls = ", ".join(f"{k}: {n} x {inv['bytes'][k]} B, {inv['seconds'][k]:.3f} s"
                                      for k, n in inv["kinds"].items())
                    log(f"tp_attack: {label}: rank {r} {s['objective']}: loss {s['loss']!r} (rel diff to one "
                        f"process {rel:.3g}, tol {TP_ATTACK_LOSS_RTOL:g}), patch gradient: 1 - cosine to the f32 "
                        f"gradient {1.0 - cos_exact:.6g} (bound {bound:.6g} = {TP_ATTACK_EXACT_FACTOR:g} x one "
                        f"process's {1.0 - want['cos_exact']:.6g}), cosine to one process's {cos:.6f}, sha256 "
                        f"{s['sha256'][:16]}, B1/B2 {s['launches']}, norm kernels {s['norm_launches']}, "
                        f"{s['seconds']:.2f} s, of which "
                        f"{sum(inv['seconds'].values()):.2f} s in collectives (host clock, the card synchronized "
                        f"around each); collectives {colls}; largest gather {inv['gather_max_bytes']} B")
                    if rel > TP_ATTACK_LOSS_RTOL or not 1.0 - cos_exact <= bound:
                        failed.append(f"{label} rank {r} {s['objective']}: loss rel {rel}, 1 - cosine to the "
                                      f"f32 gradient {1.0 - cos_exact} > {bound}")
                    if s["launches"] != want_launches:
                        failed.append(f"{label} rank {r}: B1/B2 {s['launches']} != {want_launches}")
                    if s["norm_launches"] != want_norm:
                        failed.append(f"{label} rank {r}: norm kernels {s['norm_launches']} != {want_norm}")
                    if inv["gather_max_bytes"] >= MB:
                        failed.append(f"{label} rank {r} {s['objective']}: a gather of {inv['gather_max_bytes']} B")
                    res["launches"][f"rank {r}, {s['objective']}"] = s["launches"]
                    res["rel"][f"rank {r}, {s['objective']}"] = rel
                    res["cos"][f"rank {r}, {s['objective']}"] = cos
                    res["cos_exact"][f"rank {r}, {s['objective']}"] = cos_exact
            for i, want in enumerate(ref):
                digests = {v["steps"][i]["sha256"] for v in ranks.values()}
                log(f"tp_attack: {label}: {want['objective']}: the ranks' updated patches {len(digests)} "
                    f"SHA-256 ({next(iter(digests))[:16]}; one process {want['sha256'][:16]})")
                if len(digests) != 1:
                    failed.append(f"{label}: the ranks' patches differ: {digests}")
            out[label] = res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"tp_attack: the phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:  # every check of both jobs is logged first
        raise AssertionError("tp_attack: " + "; ".join(failed))
    return out


# ------------------------------------------------------------------ train
# The VLA trainer on the 7B: the frozen-tower stage of the registered *-icy
# run configs (training/conf.py), fsdp (one rank: the same step as ddp), at
# the reference's lr 2e-5, on one fixed dummy batch of 8, prompts padded to
# 32 (S = 288). With bf16 weights and no f32 master copy (as in the JAX
# package) an Adam step below half a bf16 ulp is lost: at 2e-5 the second
# step moves ~0.29 of the LLM's elements, at 5e-4 ~0.98, but from 5e-5 up
# the random model's loss on its batch rises (scripts/sweep_train_lr.py).
TRAIN_BS, TRAIN_STEPS, TRAIN_LR = 8, 4, 2e-5
TRAIN_PEAK_GIB = 76.0
TRAIN_CHECK_LAYER = 16  # the layer whose q/k/v gradients are held against plain attention
# the two gloo ranks: the 7B's widths with 2 LLM layers, bs 8 global, 3 steps
RANK_LAYERS, RANK_STEPS = 2, 3
TRAIN_TIMEOUT_S = 400
# the tiny train-then-attack (tests/test_integration_attack.py of the JAX
# package): the action is +0.8 on bright frames and -0.8 on dark ones
BRIGHT, BRIGHT_IMG = 0.8, 56
XYZ_BRIGHT = np.array([0.8, -0.8, 0.4])


def train_config(**over) -> TrainConfig:
    kw = dict(strategy="fsdp", freeze_vision_backbone=True, learning_rate=TRAIN_LR, warmup_ratio=0.0,
              max_steps=TRAIN_STEPS)
    return TrainConfig(**{**kw, **over})


def train_memory_gib(params: dict, mask: dict) -> dict:
    """What the trainer holds, from the leaves: the weights (frozen and
    trainable), and per trainable element a gradient in the weights' dtype,
    Adam's mu in f32 and nu in the weights' dtype."""
    size = {True: 0, False: 0}
    for path, t in tree_leaves(params):
        size[mask[path]] += t.numel() * t.element_size()
    trainable = sum(t.numel() for path, t in tree_leaves(params) if mask[path])
    item = next(iter(params["llm"]["layers"].values())).element_size()
    gib = {"frozen weights": size[False] / 2**30, "trainable weights": size[True] / 2**30,
           "gradients": trainable * item / 2**30, "mu (f32)": trainable * 4 / 2**30,
           "nu": trainable * item / 2**30}
    gib["total"] = sum(gib.values())
    gib["trainable_params"] = trainable
    return gib


def picked_grads(params: dict, cfg, batch, layer: int) -> tuple:
    """One step's loss on `cfg` and the gradients of projector.fc1_w, layer
    `layer`'s q_w / k_w / v_w and its two norms' weights, the final norm's
    and lm_head (the other leaves frozen; the layer stacks as per-layer
    leaves, as the trainer passes them)."""
    picks = {("projector", "fc1_w"): None, ("llm", "lm_head"): None, ("llm", "norm"): None,
             **{("llm", "layers", k): layer for k in ("q_w", "k_w", "v_w", "attn_norm", "mlp_norm")}}
    leaves, want = {}, {}
    for path, t in tree_leaves(params):
        if path in picks and picks[path] is None:
            t = want[".".join(path)] = t.detach().requires_grad_()
        elif path in picks:
            t = list(t)
            t[layer] = want[f"llm.layers.{path[-1]}[{layer}]"] = t[layer].detach().requires_grad_()
        leaves[path] = t
    pixels = dual_normalize(batch.images).to(params["llm"]["embed"].dtype)
    loss = vla_forward(tree_from_leaves(leaves.items()), cfg, batch.input_ids, batch.attention_mask,
                       pixels, batch.labels).loss
    loss.backward()
    return loss.item(), {k: v.grad for k, v in want.items()}


def grads_against_plain(params: dict, cfg, batch) -> dict:
    """picked_grads through the kernels (B1/B2 and the norms) against the
    plain path (attn_impl="xla" under plain_blocks: plain attention and
    norms): the loss within 1e-2 relative, each gradient's cosine at least
    0.99."""
    xla_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"))
    loss_f, grad_f = picked_grads(params, cfg, batch, TRAIN_CHECK_LAYER)
    with plain_blocks():
        loss_x, grad_x = picked_grads(params, xla_cfg, batch, TRAIN_CHECK_LAYER)
    rel = abs(loss_f - loss_x) / abs(loss_x)
    cos = {k: F.cosine_similarity(g.float().flatten(), grad_x[k].float().flatten(), dim=0).item()
           for k, g in grad_f.items()}
    log(f"train: one step's loss through B1/B2 and the norm kernels {loss_f:.6g} vs plain attention and norms "
        f"{loss_x:.6g} (rel diff "
        f"{rel:.3g}, tol 1e-2); gradient cosines {cos} (tol 0.99)")
    if not (rel <= 1e-2 and all(c >= 0.99 for c in cos.values())):
        raise AssertionError(f"train: the kernel path's gradients disagree with the plain path: {rel}, {cos}")
    return {"rel": rel, "cos": cos}


def tree_digest(params: dict) -> str:
    """SHA-256 over every leaf's bytes, in path order."""
    import hashlib

    h = hashlib.sha256()
    for path, t in sorted(tree_leaves(params)):
        h.update("/".join(path).encode())
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def rank_model():
    """The two ranks' model: OpenVLA-7B's widths with RANK_LAYERS LLM layers."""
    cfg = get_config(MODEL)
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=RANK_LAYERS))


def rank_training(cfg, strategy: str, mesh=None) -> dict:
    """RANK_STEPS steps of the rank model on the fixed dummy batch: each
    step's loss, B1/B2 and norm launches, the digest of the whole tree, the
    peak."""
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    batch = next(dummy_batches(TRAIN_BS))
    torch.cuda.reset_peak_memory_stats()
    trainer = VLATrainer(params, cfg, train_config(strategy=strategy, max_steps=RANK_STEPS), mesh=mesh,
                         device=DEVICE)
    del params
    losses, launches, norms, ms = [], [], [], []
    for _ in range(RANK_STEPS):
        fa.reset_launches()
        norm_ops.reset_launches()
        t = time.perf_counter()
        losses.append(trainer.run_training(iter([batch]), 1))
        ms.append((time.perf_counter() - t) * 1e3)
        launches.append(dict(fa.flash_attention.launches))
        norms.append(dict(norm_ops.launches))
    digest = tree_digest(trainer.full_params())
    return {"losses": losses, "launches": launches, "norm_launches": norms, "step_ms": ms, "sha256": digest,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def train_rank_main(argv: list) -> int:
    """One rank of the train phase's torchrun job (`chip_smoke.py
    train-rank`): the rank model under ddp, then fsdp, each rank printing
    one `train rank r/W: {json}` line in one write."""
    from roboticattack_torch.parallel import distributed, make_mesh

    distributed.initialize_multihost(device=DEVICE)
    mesh = make_mesh(device=DEVICE)
    out = {"backend": distributed.current().backend, "device": str(mesh.device)}
    for strategy in ("ddp", "fsdp"):
        out[strategy] = rank_training(rank_model(), strategy, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    sys.stdout.write(f"train rank {mesh.rank}/{mesh.size}: {json.dumps(out)}\n")
    sys.stdout.flush()
    distributed.shutdown()
    return 0


def torchrun_train(nproc: int) -> tuple:
    """`python -m torch.distributed.run --standalone --nproc_per_node N
    chip_smoke.py train-rank` in its own process group (killed whole past
    TRAIN_TIMEOUT_S): (exit code, seconds, the `train rank` lines by rank,
    the output's tail)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           os.path.abspath(__file__), "train-rank"]
    rc, secs, out = run_job(cmd, TRAIN_TIMEOUT_S, f"torchrun train-rank x{nproc}")
    return rc, secs, rank_lines(out, "train rank"), out[-3000:]


def brightness_frames(batch: int, rng, bright=None, directional: bool = False):
    """A numpy batch of the brightness task: frames near 0.65 (bright) or
    0.35 (dark), the action +-0.8 on every dim (or, `directional`, an xyz
    direction and +-0.5 on the rest)."""
    tok = WordStubTokenizer()
    rows = []
    for _ in range(batch):
        is_bright = bool(rng.integers(2)) if bright is None else bright
        base = 0.65 if is_bright else 0.35
        img = np.clip(base + rng.normal(0, 0.03, (BRIGHT_IMG, BRIGHT_IMG, 3)), 0, 1)
        if directional:
            xyz = XYZ_BRIGHT if is_bright else -XYZ_BRIGHT
            action = np.concatenate([xyz, np.full(4, 0.5 if is_bright else -0.5)])
        else:
            action = np.full(7, BRIGHT if is_bright else -BRIGHT)
        ids, labels = build_vla_example("press the lever", action, tok)
        rows.append(dict(image=(img * 255).astype(np.uint8), input_ids=ids, labels=labels))
    return collate(rows, pad_to=32)


def brightness_batches(batch: int, seed: int, bright=None, directional: bool = False):
    rng = np.random.default_rng(seed)
    while True:
        yield brightness_frames(batch, rng, bright, directional)


def train_then_attack(device: str) -> dict:
    """The JAX package's test_train_then_attack_flips_policy on the port:
    train VLA_TINY (fp32, no kernel: the kernels take bf16) on the
    brightness task, TMA-attack it toward the bright action on dark frames,
    then run the patch through the eval paste and the decode policy; last,
    int4 policies of it with int4_kernel unset."""
    cfg = get_config("vla-tiny")
    params = init_vla_params(torch.Generator(device=device).manual_seed(0), cfg)
    trainer = VLATrainer(params, cfg, TrainConfig(strategy="ddp", learning_rate=2e-3, max_steps=160,
                                                  max_grad_norm=1.0), device=device)
    t = time.perf_counter()
    final_loss = trainer.run_training(brightness_batches(8, seed=1), num_steps=160)
    train_s = time.perf_counter() - t
    trained = trainer.params

    maskidx = list(range(7))
    target = build_tma_target_tokens(np.full(7, BRIGHT), maskidx)
    spec = engine.AttackSpec(objective="tma", geometry=False, inner_loop=2)
    val = engine.make_val_step(spec, cfg, target, maskidx)
    dark_val = engine.batch_to_device(brightness_frames(16, np.random.default_rng(2), bright=False), device)

    def draws(seed, patch_hw, batch, inner=None):
        return engine.draw_step(torch.Generator().manual_seed(seed), spec, batch.images.shape, patch_hw,
                                batch.labels.shape, inner)

    m0 = val(trained, torch.zeros((14, 14, 3), device=device), dark_val, draws(3, (14, 14), dark_val, 1))
    step = engine.make_attack_step(spec, cfg, target, maskidx)
    state = engine.init_attack_state(torch.Generator().manual_seed(4), (36, 36), device)
    batches = brightness_batches(8, seed=5, bright=False)
    for i in range(60):
        lr = cosine_schedule_with_warmup(i, 5e-2, 3, 60)
        batch = engine.batch_to_device(next(batches), device)
        state, _ = step(trained, state, batch, lr, True, draws(6 + i, (36, 36), batch))
    m1 = val(trained, state.patch, dark_val, draws(7, (36, 36), dark_val, 1))

    stats = {"synthetic": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7, "mask": [True] * 6 + [False]}}}
    policy = VLAPolicy(trained, cfg, WordStubTokenizer(), stats, "synthetic", False, device=device)
    eval_cfg = LiberoEvalConfig(x=10, y=10, resize_size=BRIGHT_IMG)
    patch_np = state.patch.cpu().numpy()
    rng = np.random.default_rng(21)
    clean_xyz, patched_xyz = [], []
    for _ in range(6):
        frame = (np.clip(0.35 + rng.normal(0, 0.03, (BRIGHT_IMG, BRIGHT_IMG, 3)), 0, 1) * 255).astype(np.uint8)
        clean_xyz.append(policy.get_action(frame, "press the lever")[:6].mean())
        patched = apply_patch_to_frame(frame, patch_np, eval_cfg)
        patched_xyz.append(policy.get_action(patched, "press the lever")[:6].mean())
    # int4 with int4_kernel unset where the kernel cannot run: the f32 model,
    # and the model in bf16 with groups of 16 (not 32 * 2^k)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    int4_default = {}
    for label, c, tree, quantize in (
            ("f32, int4", cfg, trained, "int4"),
            ("bf16, int4:16", bf16, ((p, x.to(torch.bfloat16)) for p, x in tree_leaves(trained)), "int4:16")):
        pol = VLAPolicy(tree, c, WordStubTokenizer(), stats, "synthetic", False, quantize=quantize, device=device)
        int4_default[label] = {"int4_kernel": pol.int4_kernel,
                               "action": pol.get_action(frame, "press the lever").tolist()}
    return {"final_loss": final_loss, "train_s": train_s, "int4_default": int4_default,
            "baseline_success": m0["ex_success"].float().mean().item(),
            "clean_ce": m0["ex_ce"].float().mean().item(),
            "attacked_success": m1["ex_success"].float().mean().item(),
            "attacked_ce": m1["ex_ce"].float().mean().item(),
            "clean_mean": float(np.mean(clean_xyz)), "patched_mean": float(np.mean(patched_xyz))}


def check_train_then_attack(r: dict) -> None:
    """The JAX test's thresholds: the model learned the task (loss < 0.5);
    dark frames are not already the bright action (< 0.3 success); the patch
    cuts the CE to a quarter and flips at least a quarter of the examples;
    through the eval paste and the decode, patched dark frames move the
    mean xyz action up by more than 0.5 from clean ones (< -0.3). Also: the
    int4 policies of the model that the CUDA kernel cannot take (f32; bf16
    with groups of 16), with int4_kernel unset, run with it off and return
    7 finite actions."""
    checks = {
        "final_loss < 0.5": r["final_loss"] < 0.5,
        "baseline_success < 0.3": r["baseline_success"] < 0.3,
        "attacked_ce < clean_ce * 0.25": r["attacked_ce"] < r["clean_ce"] * 0.25,
        "attacked_success >= 0.25 and > baseline": (r["attacked_success"] >= 0.25
                                                    and r["attacked_success"] > r["baseline_success"]),
        "clean_mean < -0.3": r["clean_mean"] < -0.3,
        "patched_mean > clean_mean + 0.5": r["patched_mean"] > r["clean_mean"] + 0.5,
        "int4 policies the kernel cannot take: kernel off, 7 finite actions": all(
            v["int4_kernel"] is False and len(v["action"]) == 7 and np.all(np.isfinite(v["action"]))
            for v in r["int4_default"].values()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train-then-attack failed {failed}: {r}")


def phase_train(card: str) -> dict:
    """The 7B trainer (main path: VLATrainer.run_training, step by step),
    the gradients through the kernels against plain attention, the tiny
    train-then-attack, and two gloo ranks under ddp and fsdp."""
    cfg = get_config(MODEL)
    layers = cfg.llm.num_layers
    batch_np = next(dummy_batches(TRAIN_BS))
    batch = engine.batch_to_device(batch_np, DEVICE)
    t = time.perf_counter()
    params = init_vla_params(torch.Generator(device=DEVICE).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    mask = dict(tree_leaves(trainable_mask(params, train_config())))
    reckon = train_memory_gib(params, mask)
    log(f"train: OpenVLA-7B bf16 drawn in {init_s:.1f} s; {reckon['trainable_params']:,} trainable parameters "
        f"(the towers frozen); reckoning GiB " + ", ".join(f"{k} {v:.2f}" for k, v in reckon.items()
                                                        if k != "trainable_params"))
    against = grads_against_plain(params, cfg, batch)
    gc.collect()
    torch.cuda.empty_cache()

    # a host copy of every leaf: step 1 (lr 0) must leave each bit-equal, and
    # step 2's change is counted against it
    host = {path: t.to("cpu", copy=True) for path, t in tree_leaves(params)}
    torch.cuda.reset_peak_memory_stats()
    trainer = VLATrainer(params, cfg, train_config(), device=DEVICE)
    del params
    built_gib = torch.cuda.memory_allocated() / 2**30
    losses, step_ms, launches, norms = [], [], [], []
    changed = None
    for i in range(TRAIN_STEPS):
        fa.reset_launches()  # each main-path step's count starts here
        norm_ops.reset_launches()
        t = time.perf_counter()
        losses.append(trainer.run_training(iter([batch_np]), 1))
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(dict(fa.flash_attention.launches))
        norms.append(dict(norm_ops.launches))
        if i == 0:
            moved = [p for p, t in tree_leaves(trainer.params) if not torch.equal(t, host[p].to(t.device))]
            log(f"train: step 1 (lr 0) left {len(host) - len(moved)} of {len(host)} leaves bit-equal")
            if moved:
                raise AssertionError(f"train: step 1 at lr 0 moved {moved[:5]}")
        if i == 1:
            n = total = 0
            for p, t in tree_leaves(trainer.params):
                if p[0] == "llm":
                    n += int((t != host[p].to(t.device)).sum())
                    total += t.numel()
            changed = n / total
            log(f"train: step 2 (lr {TRAIN_LR:g}) changed {n:,} of {total:,} LLM elements: share {changed:.4f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    towers = tower_blocks(cfg)
    want = {"fwd": 2 * layers + 2 * towers, "bwd": layers}
    want_norm = norm_want(want, 1, 1, trained=True)
    log(f"train: losses per step {losses}; wall ms per step {[round(x, 2) for x in step_ms]}; B1/B2 launches "
        f"per step {launches} (expected {want}: {layers} layers x 2 B1 under remat, {layers} B2; the frozen "
        f"towers' {towers} blocks x 2 B1, no B2); norm kernels per step {norms} (expected {want_norm}: the "
        f"decoder's trained norms take dx and weight-gradient launches, the frozen towers' neither); peak "
        f"{peak:.2f} GiB (limit {TRAIN_PEAK_GIB}), {built_gib:.2f} GiB once built, reckoned "
        f"{reckon['total']:.2f} GiB before activations and transients [{card}]")
    if any(n != want for n in launches):
        raise AssertionError(f"train: B1/B2 launches per step {launches} != {want}")
    if any(n != want_norm for n in norms):
        raise AssertionError(f"train: norm launches per step {norms} != {want_norm}")
    if not (np.all(np.isfinite(losses)) and losses[1] > losses[2] > losses[3]):
        raise AssertionError(f"train: the loss did not fall strictly over steps 2-4: {losses}")
    if peak > TRAIN_PEAK_GIB:
        raise AssertionError(f"train: peak {peak:.2f} GiB > {TRAIN_PEAK_GIB} GiB")
    frozen = [p for p, t in tree_leaves(trainer.params)
              if p[0] == "vision" and not torch.equal(t, host[p].to(t.device))]
    if frozen:
        raise AssertionError(f"train: frozen vision leaves moved: {frozen[:5]}")
    log("train: every vision leaf bit-equal after the 4 steps")
    del host

    # one step split in its two halves (lr 0 past max_steps), then its device profile
    placed = trainer.place(batch_np)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, grads = trainer.compute_grads(placed)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    trainer.apply_gradients(grads)
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t) * 1e3
    del grads
    log(f"train: one step's forward+backward {grads_ms:.2f} ms, AdamW update {opt_ms:.2f} ms: optimizer share "
        f"{opt_ms / (grads_ms + opt_ms):.3f} [{card}]")

    def run_step():
        trainer.step(batch_np)
        torch.cuda.synchronize()

    found = device_profile(run_step, float(np.median(step_ms[1:])), "train: one 7B step", card,
                           match=("flash_fwd_kernel", "flash_bwd_", "nvjet", "gemm"))
    del trainer, placed, batch
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    tiny = train_then_attack(DEVICE)
    log(f"train: tiny train-then-attack on the card in {time.perf_counter() - t:.1f} s (160 steps "
        f"{tiny['train_s']:.1f} s): {tiny}")
    check_train_then_attack(tiny)

    rcfg = rank_model()
    single = rank_training(rcfg, "ddp")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: the rank model ({RANK_LAYERS} LLM layers) in one process: losses {single['losses']}, "
        f"launches {single['launches']}, norm kernels {single['norm_launches']}, step ms "
        f"{[round(x, 2) for x in single['step_ms']]}, peak "
        f"{single['peak_gib']:.2f} GiB [{card}]")
    rc, secs, ranks, tail = torchrun_train(2)
    if rc != 0 or sorted(ranks) != [0, 1]:
        raise AssertionError(f"train: torchrun train-rank x2 exit {rc}, rank lines {sorted(ranks)}\n{tail}")
    want_rank = {"fwd": 2 * RANK_LAYERS + 2 * towers, "bwd": RANK_LAYERS}
    want_rank_norm = norm_want(want_rank, 1, 1, trained=True)
    digests = set()
    for r, v in sorted(ranks.items()):
        for strategy in ("ddp", "fsdp"):
            run = v[strategy]
            digests.add(run["sha256"])
            rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], single["losses"]))
            log(f"train: rank {r}/2 {strategy} ({v['backend']}, {v['device']}): losses {run['losses']} (max rel "
                f"diff to one process {rel:.3g}, tol 1e-2), launches {run['launches']}, norm kernels "
                f"{run['norm_launches']} (expected {want_rank_norm} a step), step ms "
                f"{[round(x, 2) for x in run['step_ms']]}, peak {run['peak_gib']:.2f} GiB, sha256 "
                f"{run['sha256'][:16]} (two processes sharing one card) [{card}]")
            if (rel > 1e-2 or any(n != want_rank for n in run["launches"])
                    or any(n != want_rank_norm for n in run["norm_launches"])):
                raise AssertionError(f"train: rank {r} {strategy}: losses {run['losses']} vs {single['losses']}, "
                                     f"launches {run['launches']} != {want_rank}, norms {run['norm_launches']} != "
                                     f"{want_rank_norm}")
    if len(digests) != 1:
        raise AssertionError(f"train: parameter digests differ across ranks or strategies: {digests}")
    log(f"train: torchrun x2 exit {rc} in {secs:.1f} s; one parameter sha256 across ranks and strategies")
    return {"launches": launches, "norm_launches": norms, "losses": losses, "step_ms": step_ms, "peak_gib": peak,
            "reckon": reckon,
            "changed": changed, "grads_ms": grads_ms, "opt_ms": opt_ms, "device": found, "against": against,
            "tiny": tiny, "ranks": {r: {s: v[s]["launches"][0] for s in ("ddp", "fsdp")} for r, v in ranks.items()},
            "rank_seconds": secs}


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

    rows, checked = phase_kernels(bw)
    res = phase_slice(card)
    opts = phase_options(res, card)
    for key in ("policy", "base"):  # the int4 policy of the serving phases
        del res[key]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"freed the serving phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    flash = phase_flash(bw, card)
    norms = phase_norm(bw, card)
    att = phase_attack(card)
    data = phase_data(card, att)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    audits = None
    try:
        try:
            ckpt = phase_checkpoint(card, root)
            gc.collect()
            torch.cuda.empty_cache()
            ev = phase_eval(card, root)
            gc.collect()
            torch.cuda.empty_cache()
            ver = phase_verify(card, root)
            gc.collect()
            torch.cuda.empty_cache()
            audits = Audits()  # on the host's cores while the card runs the tp and tp_attack jobs
            tpr = phase_tp(card, root, audits)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        rows_by_tp = {}
        for run in tpr.values():
            rows_by_tp[run["tp"]] = sorted(set(rows_by_tp.get(run["tp"], [])) | set(run["rows"]))
        tp_rows = phase_kernels_tp(bw, rows_by_tp)
        ddp = phase_ddp(card)
        gc.collect()
        torch.cuda.empty_cache()
        tpa = phase_tp_attack(card, audits)
        log(f"audits: the tp ranks' decode layouts in {audits.result('decode')['seconds']:.1f} s, the tp_attack "
            f"ranks' steps in {audits.result('attack')['seconds']:.1f} s (meta tensors, a fake process group, "
            f"no card; a process of their own beside the jobs)")
    finally:
        if audits is not None:
            audits.close()
    flash_tp = phase_flash_tp(bw, card)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(card)

    kernels = []
    for kind, (kname, replaces) in FLASH_KERNELS.items():
        t = flash["timing"][kind]
        kernels.append({
            "name": kname, "route": "cuda", "source": FLASH_SOURCE, "replaces": replaces,
            "launches": att["launches"][kind],
            "max_abs_err": max([flash["errs"][kind]] + [r["errs"][kind] for r in flash_tp.values()]),
            "launches_by_path": {"attack CLI (seeded weights)": att["launches"][kind],
                                 f"attack CLI on RLDS data ({DATA_LAYER})": data["launches"][kind],
                                 "attack CLI --checkpoint (1 step x 1 inner + 1 val)":
                                     ckpt["attack_launches"][kind],
                                 "verify_checkpoint TMA smoke (bs 2)": ver["smoke_launches"][kind],
                                 **{f"torchrun cli.attack --data_parallel, {label}, rank {r}": n[kind]
                                    for label, run in ddp.items() for r, n in run["launches"].items()},
                                 **{f"VLATrainer 7B (fsdp, towers frozen), step {i + 1}": n[kind]
                                    for i, n in enumerate(train["launches"])},
                                 **{f"torchrun train-rank (7B, {RANK_LAYERS} layers), {s}, rank {r}, step 1": n[s][kind]
                                    for r, n in train["ranks"].items() for s in ("ddp", "fsdp")},
                                 **{f"torchrun tp-attack-rank ({label}), {k} inner step": n[kind]
                                    for label, run in tpa.items() for k, n in run["launches"].items()}},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "at": f"[{ATTACK_BS}, 32, {256 + PAD_TO}, 128] bf16 with a dummy batch's causal + "
                  "padding bias, per launch; launches from the CLI run",
            "max_abs_err_over": "phase_flash's shapes (the benchmark cells' included) and the tp_attack ranks' "
                                "local-head shapes",
            "on_main_path": True,
            "per_rank_shapes": {
                f"{label} rank {r['shape']}": {
                    "ms": r["timing"][kind]["ms"], "plain_ms": r["timing"][kind]["plain_ms"],
                    "bound_ms": r["timing"][kind]["bound_ms"], "bound_by": r["timing"][kind]["bound_by"],
                    "library_ms": r["timing"][kind]["library_ms"], "max_abs_err": r["errs"][kind],
                    "at": f"a {label} attack rank's local heads, bf16, the dummy batch's bias, per launch"}
                for label, r in flash_tp.items()},
            "per_cell_shapes": {
                f"{label} {r['shape']} kv heads {r['kv_heads']}{'' if r['bias'] else ', no bias'}": {
                    "ms": r["timing"][kind]["ms"], "plain_ms": r["timing"][kind]["plain_ms"],
                    "bound_ms": r["timing"][kind]["bound_ms"], "bound_by": r["timing"][kind]["bound_by"],
                    "library_ms": r["timing"][kind]["library_ms"], "max_abs_err": r["errs"][kind]}
                for label, r in flash["cells"].items()},
        })
    for mode, (kname, replaces) in KERNELS.items():
        def layer_sum(key, m=8, gs=GROUP):
            return sum(r[key] * r["per_layer"] for r in rows if r["mode"] == mode and r["m"] == m and r["group"] == gs)

        held = [r for r in rows + checked if r["mode"] == mode]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": res["launches"][mode],
            "max_abs_err": max([r["max_abs_err"] for r in held]
                               + ([r["max_abs_err"] for r in tp_rows.values()] if mode == "grouped" else [])),
            "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
            "bound_ms": layer_sum("bound_ms"),
            "bound_by": "bytes" if layer_sum("byte_ms") >= layer_sum("op_ms") else "operations",
            "library_ms": layer_sum("library_ms"),
            "at": f"one decoder layer's 7 projections at m=8, groups of {GROUP} (4x 4096x4096, "
                  "2x 11008x4096, 1x 4096x11008), summed per-launch times",
            "max_abs_err_over": "; ".join(sorted({f"groups of {r['group']} at m={r['m']}" for r in held}))
                                + " (the 7B shapes; each bit-equal across two launches)"
                                + ("; a tp rank's shapes at every m its runs gave them: "
                                   + "; ".join(f"tp={tp}, groups of {r['group']}, at m={'/'.join(map(str, r['by_m']))}"
                                               for tp, r in tp_rows.items()) if mode == "grouped" else ""),
            "on_main_path": mode == "grouped",
        })
        if mode == "grouped":
            m56 = [r for r in rows if r["mode"] == mode and r["m"] == JACOBI_M and r["group"] == GROUP]
            kernels[-1].update({
                "launches_by_path": {"slice (HTTP, sequential tail)": res["launches"][mode],
                                     "checkpoint (loaded policy, one bs 8 decode)":
                                         ckpt["decode_launches"],
                                     "checkpoint (HTTP over the loaded policy)": ckpt["http_launches"],
                                     **{f"eval_libero {k} (int4, from the checkpoint)": v["b4"]["grouped"]
                                        for k, v in ev["runs"].items()},
                                     "verify_checkpoint quant int4+qk (bs 2, 2 batches)": ver["quant_launches"],
                                     **{f"torchrun {label}, rank {r}": n
                                        for label, run in tpr.items() for r, n in run["b4_per_rank"].items()},
                                     **{f"options Jacobi HTTP {k}": v for k, v in opts["jacobi_launches"].items()}},
                "jacobi_verify_passes": {"round 1": opts["passes"][0], "round 2": opts["passes"][1]},
                "ms_m56": layer_sum("ms", JACOBI_M), "plain_ms_m56": layer_sum("plain_ms", JACOBI_M),
                "bound_ms_m56": layer_sum("bound_ms", JACOBI_M),
                "library_ms_m56": layer_sum("library_ms", JACOBI_M),
                "max_abs_err_m56": max(r["max_abs_err"] for r in m56),
                "at_m56": "the Jacobi pass at bs 8, y [8, 7, in]: one layer's 7 projections, "
                          "summed per-launch times",
                "layers": {
                    f"groups of {gs}, m={m}": {
                        "ms": layer_sum("ms", m, gs), "plain_ms": layer_sum("plain_ms", m, gs),
                        "bound_ms": layer_sum("bound_ms", m, gs), "library_ms": layer_sum("library_ms", m, gs),
                        "bound_by": "bytes" if layer_sum("byte_ms", m, gs) >= layer_sum("op_ms", m, gs)
                        else "operations"}
                    for gs in GROUPS for m in M_ROWS},
                "per_rank_shapes": {
                    f"tp {tp} m={m}": {"group": r["group"], "ms": t["ms"],
                                       "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                                       "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                                       "max_abs_err_tp": r["max_abs_err"],
                                       "at": f"one tp={tp} rank's 7 projections of a layer at m={m}, "
                                             "summed per-launch times"}
                    for tp, r in tp_rows.items() for m, t in r["by_m"].items()},
            })
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels, "norm": norms}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["tp-rank"]:  # one rank of a phase_tp run (torchrun starts it)
        sys.exit(tp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["train-rank"]:  # one rank of phase_train's gloo run
        sys.exit(train_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["tp-attack-rank"]:  # one rank of a phase_tp_attack job
        sys.exit(tp_attack_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["audits"]:  # the tp and tp_attack ranks' audits, without the card (Audits)
        sys.exit(audits_main(sys.argv[2:]))
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
