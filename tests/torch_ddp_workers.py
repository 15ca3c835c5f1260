"""Rank functions of the two-process tests (test_torch_ddp.py) and the
launcher that runs them. The spawned ranks import this module, so it
imports no JAX: the JAX side of each comparison runs in the test's own
process."""

import contextlib
import os
import socket
import time

import torch
import torch.multiprocessing as mp

from roboticattack_torch.utils.profiling import counting_collectives

# a hung collective fails its test here, long before the suite's clock
SPAWN_TIMEOUT_S = 120


def start_ranks(fn, nprocs: int, *args):
    """fn(rank, *args) in `nprocs` spawned processes; wait with wait_ranks."""
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    ctx.started = time.monotonic()
    return ctx


def wait_ranks(ctx, timeout: float = SPAWN_TIMEOUT_S) -> None:
    """Raises if a rank raised, or if the ranks are not all done `timeout`
    seconds after their start (then every rank is killed)."""
    deadline = ctx.started + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        assert not any(p.is_alive() for p in ctx.processes)


def run_ranks(fn, nprocs: int, *args, timeout: float = SPAWN_TIMEOUT_S) -> None:
    wait_ranks(start_ranks(fn, nprocs, *args), timeout)


def _mesh(rank: int, world: int, init: str):
    torch.set_num_threads(1)
    from roboticattack_torch.parallel import initialize_multihost, make_mesh

    initialize_multihost(init, num_processes=world, process_id=rank, device="cpu")
    return make_mesh(device="cpu")


def _name_shape(log: list) -> list:
    """(name, shape) of each recorded collective."""
    return [(c.name, c.shape) for c in log]


def _copy_state(state):
    from roboticattack_torch.attacks.engine import AttackState
    from roboticattack_torch.attacks.optimizer import AdamState

    return AttackState(patch=state.patch.clone(), opt=AdamState(*(t.clone() for t in state.opt)),
                       grad_acc=state.grad_acc.clone())


def val_draws(draws):
    """A step's draws cut to the val step's one inner step."""
    return draws._replace(inner=draws.inner[:1])


def steps_rank(rank: int, world: int, init: str, payload: str, out_dir: str) -> None:
    """One outer step of every case of the payload on this rank's rows:
    `gspmd` cases take the global draws (and also run the val step),
    `exact` cases this rank's own."""
    from roboticattack_torch.attacks.ddp import make_ddp_attack_step
    from roboticattack_torch.attacks.engine import AttackSpec, batch_to_device, make_attack_step, make_val_step
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.parallel import distributed, shard_batch

    mesh = _mesh(rank, world, init)
    p = torch.load(payload, weights_only=False)
    out = {}
    for name, case in p["cases"].items():
        spec = AttackSpec(**case["spec"])
        batch = batch_to_device(shard_batch(case["batch"], mesh), "cpu")
        log = []
        with counting_collectives(log):
            if case["semantics"] == "exact":
                step = make_ddp_attack_step(spec, VLA_TINY, case["target"], case["maskidx"], mesh)
                state, metrics = step(p["params"], _copy_state(p["state"]), batch, case["lr"],
                                      case["draws"][rank])
            else:
                step = make_attack_step(spec, VLA_TINY, case["target"], case["maskidx"], mesh)
                state, metrics = step(p["params"], _copy_state(p["state"]), batch, case["lr"], True,
                                      case["draws"])
        out[name] = {"state": state, "metrics": metrics, "collectives": _name_shape(log)}
        if case["semantics"] == "gspmd":  # the val step on the global batch's first inner draws
            val = make_val_step(spec, VLA_TINY, case["target"], case["maskidx"], mesh)
            out[name]["val"] = val(p["params"], p["state"].patch, batch, val_draws(case["draws"]))
    torch.save(out, os.path.join(out_dir, f"steps_rank{rank}.pt"))
    distributed.shutdown()


def tiny_batches(bs: int, seed: int):
    from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
    from roboticattack_torch.utils.prompting import WordStubTokenizer

    return batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=56, seed=seed), bs, pad_to=48)


def runner_rank(rank: int, world: int, init: str, payload: str, out_dir: str, cli_argv: list) -> None:
    """The runs of the payload's `runs` (name -> (semantics, AttackConfig
    fields, params key); rank r > 0 is given its own run dir,
    <name>_rank<r>, which must stay unwritten), then the CLI as a torchrun
    rank (cli_rank) in <out_dir>/cli."""
    from roboticattack_torch.attacks.attacker import AttackConfig, OpenVLAAttacker
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.parallel import distributed

    mesh = _mesh(rank, world, init)
    p = torch.load(payload, weights_only=False)
    out = {}
    for name, (sem, attack, params) in p["runs"].items():
        save_dir = os.path.join(out_dir, name if rank == 0 else f"{name}_rank{rank}")
        runner = OpenVLAAttacker(p[params], VLA_TINY, save_dir,
                                 AttackConfig(**attack, ddp_semantics=sem), mesh=mesh)
        res = runner.run(tiny_batches(8, 0), tiny_batches(8, 1))
        out[name] = {"patch": res.patch, "best": res.best_metric, "histories": res.histories,
                     "writes": runner.writes}
    # one more step of the gspmd run, resumed from its state of step 2: rank
    # 0 reads it and broadcasts it; rank 1 is pointed at no directory at all
    runner = OpenVLAAttacker(p["params"], VLA_TINY, os.path.join(out_dir, "resume" if rank == 0 else "resume_rank1"),
                             AttackConfig(**dict(p["attack"], num_iter=4)), mesh=mesh)
    res = runner.run(tiny_batches(8, 0), tiny_batches(8, 1),
                     resume_from=os.path.join(out_dir, "gspmd" if rank == 0 else "nowhere"))
    out["resume"] = {"patch": res.patch, "best": res.best_metric, "histories": res.histories}
    torch.save(out, os.path.join(out_dir, f"runner_rank{rank}.pt"))
    distributed.shutdown()
    cli_rank(rank, world, os.path.join(out_dir, "cli"), cli_argv)


def _master_port(rank: int, workdir: str) -> int:
    """A free port that rank 0 takes just before it binds it and hands to
    the other ranks through <workdir>/port."""
    path = os.path.join(workdir, "port")
    if rank == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with open(path + ".tmp", "w") as f:
            f.write(str(port))
        os.replace(path + ".tmp", path)
        return port
    deadline = time.monotonic() + 60
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("rank 0 wrote no port")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def cli_rank(rank: int, world: int, workdir: str, argv: list) -> None:
    """`cli.attack.main(argv)` as a torchrun rank: the rendezvous from
    MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, stdout to
    stdout_rank<r>.txt, run from `workdir`."""
    port = _master_port(rank, workdir)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    os.chdir(workdir)
    from roboticattack_torch.cli import attack

    with open(f"stdout_rank{rank}.txt", "w") as f, contextlib.redirect_stdout(f):
        attack.main(argv)



def train_rank(rank: int, world: int, init: str, payload: str, out_dir: str) -> None:
    """The payload's training run under ddp and then fsdp on this rank:
    each step's loss and collectives, what the rank keeps, and the whole
    tree after the last step (tests/test_torch_training_ddp.py)."""
    from roboticattack_torch.models.param_tree import tree_from_leaves, tree_leaves
    from roboticattack_torch.parallel import distributed
    from roboticattack_torch.training import TrainConfig, VLATrainer

    mesh = _mesh(rank, world, init)
    p = torch.load(payload, weights_only=False)
    out = {}
    for strategy in ("ddp", "fsdp"):
        params = tree_from_leaves((path, t.clone()) for path, t in tree_leaves(p["params"]))
        init_log = []
        with counting_collectives(init_log):
            trainer = VLATrainer(params, p["model_cfg"], TrainConfig(strategy=strategy, **p["train"]),
                                 mesh=mesh, device="cpu")
        losses, logs = [], []
        for batch in p["batches"]:
            logs.append([])
            with counting_collectives(logs[-1]):
                losses.append(trainer.run_training(iter([batch]), 1))
        kept = {path: tuple(t.shape) for path, t in tree_leaves(trainer.params)}
        full = {path: t.clone() for path, t in tree_leaves(trainer.full_params())}
        out[strategy] = {"losses": losses, "collectives": [_name_shape(x) for x in logs], "init": _name_shape(init_log),
                         "kept": kept, "params": full}
    torch.save(out, os.path.join(out_dir, f"train_rank{rank}.pt"))
    distributed.shutdown()
