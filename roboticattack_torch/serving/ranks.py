"""The rank-0 front end of tensor- and data-parallel serving.

JAX serves a dp x tp mesh from one process. Here each rank is a process
(torchrun), so one of them has to own the front end: rank 0 runs the HTTP
server, the batcher, the warmup and the evaluation's environment loop, and
every decode it makes (`VLAPolicy.decode_inputs` under a mesh) first
broadcasts one header to every rank: the input shapes and dtypes, the
call's decode options, whether a draft comes, `num_steps`, or `stop`. Then
it broadcasts the input tensors, and every rank decodes its share with the
same code (`decode_on_ranks`). The other ranks run `follow(policy)`, which
decodes each header's batch and returns at `stop`.

A rank that fails exits non-zero, and torchrun then tears the job down:
rank 0 leaves the process (`os._exit(1)`) when a decode fails after its
header went out, because the batcher would otherwise catch the error and
keep serving beside ranks that are out of step. Inputs that one process
would refuse are refused on rank 0 before the header, so a bad request
fails alone.

    torchrun --nproc_per_node 4 -m roboticattack_torch.cli.serve \\
        --checkpoint DIR --quantize int4 --dp 2 --tp 2
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from ..models.decode import KV_CACHE_MODES, DecodeResult, greedy_decode_actions

def _broadcast_header(header: Optional[dict]) -> dict:
    box = [header]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _check_call(policy, inputs, draft_tokens, num_steps: int, opts: dict) -> None:
    """What greedy_decode_actions would refuse, refused on rank 0 before the
    header goes out."""
    b = inputs[0].shape[0]
    if opts["kv_cache"] not in KV_CACHE_MODES:
        raise ValueError(f"kv_cache={opts['kv_cache']!r}; supported: None, 'int8', 'int4'")
    if opts["act_quant"] not in (None, "int8"):
        raise ValueError(f"act_quant={opts['act_quant']!r}; supported: None, 'int8'")
    vt = opts["visual_tokens"]
    if vt is not None and not 1 <= vt <= policy.cfg.num_patches:
        raise ValueError(f"visual_tokens={vt} must be in [1, {policy.cfg.num_patches}]")
    if not 1 <= num_steps:
        raise ValueError(f"num_steps={num_steps} must be >= 1")
    if draft_tokens is not None:
        if tuple(draft_tokens.shape) != (b, num_steps):
            raise ValueError(
                f"draft_tokens shape {tuple(draft_tokens.shape)}; expected {(b, num_steps)} "
                "(one draft token per decode position)"
            )
        if bool(((draft_tokens < 0) | (draft_tokens >= policy.vocab_size)).any()):
            raise ValueError(f"draft_tokens hold ids outside [0, {policy.vocab_size})")


def lead(policy, inputs, draft_tokens, num_steps: int, opts: dict) -> DecodeResult:
    """Rank 0's decode under a mesh: the header, the inputs, then this
    rank's share of the decode; the whole batch's result."""
    _check_call(policy, inputs, draft_tokens, num_steps, opts)
    tensors = list(inputs) + ([draft_tokens] if draft_tokens is not None else [])
    _broadcast_header({"stop": False, "num_steps": num_steps, "opts": opts,
                       "inputs": [(tuple(t.shape), t.dtype) for t in tensors]})
    try:
        for t in tensors:
            dist.broadcast(t, src=0)
        return decode_on_ranks(policy, tensors[:3], tensors[3] if len(tensors) > 3 else None,
                               num_steps, opts)
    except Exception:
        # the other ranks are inside this decode's collectives: no rank may
        # go on serving without them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def follow(policy) -> int:
    """A rank other than 0: decode every batch rank 0's headers announce,
    until `stop`; returns the number of decodes."""
    n = 0
    while True:
        header = _broadcast_header(None)
        if header["stop"]:
            return n
        tensors = [torch.empty(shape, dtype=dtype, device=policy.device) for shape, dtype in header["inputs"]]
        for t in tensors:
            dist.broadcast(t, src=0)
        decode_on_ranks(policy, tensors[:3], tensors[3] if len(tensors) > 3 else None,
                        header["num_steps"], header["opts"])
        n += 1


def stop(policy) -> None:
    """Rank 0: release the followers (each `follow` returns)."""
    if policy.mesh is not None and policy.mesh.world > 1:
        _broadcast_header({"stop": True})


def run(policy, main):
    """`main()` on rank 0, then `stop`, even when main raises; `follow` on
    every other rank. Returns main's result on rank 0, None elsewhere."""
    mesh = policy.mesh
    if mesh is None or mesh.world == 1:
        return main()
    if mesh.rank != 0:
        follow(policy)
        return None
    try:
        return main()
    finally:
        stop(policy)


def decode_on_ranks(policy, inputs, draft_tokens, num_steps: int, opts: dict) -> DecodeResult:
    """This rank's share of one decode: its replica's rows when dp divides
    the batch (else the whole batch, with a warning once a batch size), the
    decode over its shard, and on the first model rank of each replica the
    replicas' rows gathered back in order. Records the decode's wall ms and
    int4-kernel (B4) launches in `policy.decode_log`."""
    from ..ops.q4_matmul import q4_matmul

    mesh = policy.mesh
    ids, mask, pixels = inputs
    b = ids.shape[0]
    split = mesh.dp > 1 and b % mesh.dp == 0
    if mesh.dp > 1 and not split and b not in policy._dp_warned:
        policy._dp_warned.add(b)
        if mesh.rank == 0:
            print(f"WARNING: batch {b} not divisible by the mesh's data axis ({mesh.dp}); "
                  f"serving this batch size replicated (no dp speedup)", file=sys.stderr, flush=True)
    if split:
        n = b // mesh.dp
        rows = slice(mesh.d * n, (mesh.d + 1) * n)
        ids, mask, pixels = ids[rows], mask[rows], pixels[rows]
        draft_tokens = None if draft_tokens is None else draft_tokens[rows]
    before = q4_matmul.launches["grouped"]
    cuda = policy.device.type == "cuda"
    t = time.perf_counter()
    with torch.inference_mode():
        res = greedy_decode_actions(policy.model.tree(), policy.cfg, ids, mask, pixels, num_steps=num_steps,
                                    cooked_weights=True, mesh=mesh, draft_tokens=draft_tokens, **opts)
    if cuda:
        torch.cuda.synchronize(policy.device)
    policy.decode_log.append({"rows": int(ids.shape[0]), "ms": (time.perf_counter() - t) * 1e3,
                              "b4": q4_matmul.launches["grouped"] - before})
    if split and mesh.m == 0:
        res = res._replace(tokens=_gather_rows(res.tokens, mesh), actions=_gather_rows(res.actions, mesh),
                           logits=None if res.logits is None else _gather_rows(res.logits, mesh))
    return res


def _gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.dp_group)
    return torch.cat(parts)


def print_rank_report(policy) -> None:
    """This rank's `serving rank r/W: {json}` line (rank_report), written in
    one call: the ranks share one output, and a line written in two parts
    can have another rank's text between them."""
    mesh = policy.mesh
    sys.stdout.write(f"serving rank {mesh.rank}/{mesh.world}: {json.dumps(rank_report(policy))}\n")
    sys.stdout.flush()


def rank_report(policy) -> dict:
    """This rank's numbers for the CLIs' `serving rank r/W: {json}` line:
    its place, backend and device, the peak memory of its load and of its
    run, and the last 1024 decodes' rows, wall ms and int4-kernel launches
    (B4)."""
    mesh = policy.mesh
    cuda = policy.device.type == "cuda"
    log = policy.decode_log
    return {
        "rank": mesh.rank, "world": mesh.world, "tp": mesh.tp, "dp": mesh.dp,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(policy.device),
        "load_peak_gib": policy.load_peak_gib,
        "load_held_gib": policy.load_held_gib,
        "run_peak_gib": torch.cuda.max_memory_allocated(policy.device) / 2**30 if cuda else None,
        "decodes": len(log), "rows": [e["rows"] for e in log], "decode_ms": [e["ms"] for e in log],
        "b4": [e["b4"] for e in log],
    }
