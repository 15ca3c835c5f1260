"""Rank functions of the tensor- and data-parallel serving tests
(test_torch_tp_serving.py). The spawned ranks import this module, so it
imports no JAX: the JAX side of each comparison runs in the test's own
process. The launcher is torch_ddp_workers'."""

import contextlib
import io
import os
import re
import signal
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from roboticattack_torch.utils.profiling import counting_collectives
from torch_ddp_workers import _copy_state, _master_port

STATS = {"k": {"action": {"q01": [-0.2] * 7, "q99": [0.4] * 7, "mask": [True] * 6 + [False]}}}


def quantized_tree(params, quant, group_size):
    """The single process's cooked (and quantized) decode tree."""
    from roboticattack_torch.models.decode import decode_layout_params
    from roboticattack_torch.models.quant import quantize_decode_params

    cooked = decode_layout_params(params)
    return cooked if quant is None else quantize_decode_params(cooked, quant, group_size)


def _join(rank: int, world: int, init: str, tp: int, dp: int):
    torch.set_num_threads(1)
    from roboticattack_torch.parallel import initialize_multihost, make_serving_mesh

    initialize_multihost(init, num_processes=world, process_id=rank, device="cpu")
    return make_serving_mesh(tp, dp, device="cpu")


def decode_cases(mesh, p: dict) -> dict:
    """Every decode case on this rank's shard and its replica's rows,
    with the collectives it made."""
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.models.decode import greedy_decode_actions
    from roboticattack_torch.parallel import shard_decode_params

    ids, mask, px = p["inputs"]
    n = ids.shape[0] // mesh.dp
    rows = slice(mesh.d * n, (mesh.d + 1) * n)
    out = {}
    for name, case in p["cases"].items():
        local = shard_decode_params(quantized_tree(p["params"], case["quant"], case["gs"]), mesh)
        kw = dict(case["kw"])
        if kw.get("draft_tokens") is not None:
            kw["draft_tokens"] = kw["draft_tokens"][rows]
        log = []
        with counting_collectives(log), torch.inference_mode():
            r = greedy_decode_actions(local, VLA_TINY, ids[rows], mask[rows], px[rows], cooked_weights=True,
                                      mesh=mesh, **kw)
        out[name] = {"result": r, "collectives": log}
    return out


def policy_checks(mesh, p: dict) -> dict:
    """VLAPolicy(mesh=...) loaded leaf by leaf: its shard, and on rank 0
    the actions of a batch dp divides and of one it does not (stderr
    kept); the other ranks follow."""
    from roboticattack_torch.eval.policy import VLAPolicy
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.serving import ranks
    from roboticattack_torch.utils.prompting import WordStubTokenizer

    out = {}
    for quant in p["policy_quants"]:
        policy = VLAPolicy(p["params"], VLA_TINY, WordStubTokenizer(), STATS, quantize=quant, device="cpu",
                           mesh=mesh)
        out[f"shard_{quant}"] = policy.model.tree()

        def lead():
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                odd = policy.get_action_multi(p["frames"][:3], p["tasks"][:3])
                odd_again = policy.get_action_multi(p["frames"][:3], p["tasks"][:3])
            even = policy.get_action_multi(p["frames"], p["tasks"])
            return {"odd": odd, "odd_again": odd_again, "even": even, "stderr": err.getvalue()}

        got = ranks.run(policy, lead)
        out[f"actions_{quant}"] = got
        out[f"log_{quant}"] = policy.decode_log
    return out


def serve_cli_rank(rank: int, world: int, workdir: str, argv: list, frames, tasks) -> dict:
    """`cli.serve.main(argv)` as a torchrun rank (port 0). On rank 0 a
    client thread reads the port from the served line, POSTs one request a
    frame from its own thread, GETs /healthz and interrupts the server as
    Ctrl-C would; every rank's stdout is kept."""
    import json
    import urllib.request

    from roboticattack_torch.cli import serve

    _torchrun_env(rank, world, workdir)
    path = os.path.join(workdir, f"serve_stdout_rank{rank}.txt")
    replies = [None] * len(frames)
    health = {}

    def client():
        deadline = time.monotonic() + 120
        url = None
        while url is None and time.monotonic() < deadline:
            m = re.search(r"serving on (http://\S+)", open(path).read())
            url = m.group(1) if m else time.sleep(0.05)

        def post(i):
            body = json.dumps({"task": tasks[i], "image": frames[i].tolist()}).encode()
            req = urllib.request.Request(url + "/act", data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                replies[i] = json.loads(resp.read())

        try:
            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(frames))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
                health.update(json.loads(resp.read()))
        finally:
            os.kill(os.getpid(), signal.SIGINT)

    with open(path, "w") as f, contextlib.redirect_stdout(f):
        if rank == 0:
            threading.Thread(target=client, daemon=True).start()
        serve.main(argv)
    return {"replies": replies, "health": health, "stdout": open(path).read()}


def eval_cli_rank(rank: int, world: int, workdir: str, argv: list, episodes: list, real_steps: int) -> str:
    """`cli.eval_libero.main(argv)` as a torchrun rank over chip_smoke's
    replay `libero`; returns the rank's stdout."""
    import chip_smoke
    from roboticattack_torch.cli import eval_libero

    _torchrun_env(rank, world, workdir)
    buf = io.StringIO()
    with chip_smoke.ReplayLibero(episodes, real_steps), contextlib.redirect_stdout(buf):
        eval_libero.main(argv)
    return buf.getvalue()


def _torchrun_env(rank: int, world: int, workdir: str) -> None:
    port = _master_port(rank, workdir)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))


def serving_rank(rank: int, world: int, tp: int, dp: int, init: str, payload: str, out_dir: str) -> None:
    """The decode cases, the policy checks, then the layout's CLI: cli.serve
    at dp x tp > 2 ranks, cli.eval_libero otherwise."""
    from roboticattack_torch.parallel import distributed

    mesh = _join(rank, world, init, tp, dp)
    p = torch.load(payload, weights_only=False)
    out = {"decode": decode_cases(mesh, p), "policy": policy_checks(mesh, p)}
    distributed.shutdown()
    workdir = os.path.join(out_dir, f"cli_{tp}x{dp}")
    os.makedirs(workdir, exist_ok=True)
    if dp > 1:
        out["serve"] = serve_cli_rank(rank, world, workdir, p["serve_argv"], p["frames"][:2], p["tasks"][:2])
    else:
        out["eval"] = eval_cli_rank(rank, world, workdir, p["eval_argv"] + ["--output", os.path.join(workdir, "eval")],
                                    p["episodes"], p["real_steps"])
    sys.stdout.flush()
    torch.save(out, os.path.join(out_dir, f"tp{tp}_dp{dp}_rank{rank}.pt"))


def tp_attack_case(mesh, p: dict, case: dict) -> dict:
    """One case of the attack under a model axis on this rank: its shard
    cut from the payload's tree, its replica's rows, then the attack step
    (and the val and clean-filter steps) or, for `forward`, vla_forward's
    loss and pixel gradient; with the collectives of the step or forward."""
    from roboticattack_torch.attacks import engine
    from roboticattack_torch.models.vlm import vla_forward
    from roboticattack_torch.parallel import shard_batch, shard_params

    cfg = case["cfg"]
    local = shard_params(p[case["params"]], mesh, shard_projector=case["shard_projector"])
    out, log = {}, []
    if case["kind"] == "forward":
        ids, mask, pixels, labels = shard_batch(case["inputs"], mesh)
        px = pixels.clone().requires_grad_()
        with counting_collectives(log):
            fwd = vla_forward(local, cfg, ids, mask, px, labels, mesh=mesh)
            fwd.loss.backward()
        return {"loss": fwd.loss.detach(), "logits": fwd.logits.detach(), "grad": px.grad, "collectives": log}
    spec = engine.AttackSpec(**case["spec"])
    batch = engine.batch_to_device(shard_batch(p["batch"], mesh), "cpu")
    step = engine.make_attack_step(spec, cfg, case["target"], case["maskidx"], mesh)
    with counting_collectives(log):
        state, metrics = step(local, _copy_state(p["state"]), batch, case["lr"], True, case["draws"])
    out.update(state=state, metrics=metrics, collectives=log)
    if case["val_draws"] is not None:
        val = engine.make_val_step(spec, cfg, case["target"], case["maskidx"], mesh)
        out["val"] = val(local, p["state"].patch, batch, case["val_draws"])
        out["clean"] = engine.make_clean_filter_step(cfg, mesh)(local, batch)
    return out


def tp_attack_rank(rank: int, world: int, tp: int, dp: int, init: str, payload: str, out_dir: str) -> None:
    """The payload's cases of this layout (dp x tp) on this rank of a
    make_mesh(data=dp, model=tp) grid, saved with the rank's place in it."""
    torch.set_num_threads(1)
    from roboticattack_torch.parallel import distributed, initialize_multihost, make_mesh

    initialize_multihost(init, num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh(data=dp, model=tp, device="cpu")
    p = torch.load(payload, weights_only=False)
    out = {"place": {"d": mesh.d, "m": mesh.m, "dp": mesh.dp, "tp": mesh.tp,
                     "model_group": tuple(dist.get_process_group_ranks(mesh.model_group)),
                     "data_group": tuple(dist.get_process_group_ranks(mesh.group))}}
    for name, case in p["cases"].items():
        if tuple(case["layout"]) == (tp, dp):
            out[name] = tp_attack_case(mesh, p, case)
    torch.save(out, os.path.join(out_dir, f"tp_attack_tp{tp}_dp{dp}_rank{rank}.pt"))
    distributed.shutdown()
