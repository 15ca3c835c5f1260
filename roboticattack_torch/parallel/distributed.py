"""Process-group initialization: the data-parallel attack's rendezvous (the
JAX package's `parallel/distributed.py`).

The reference launches its DDP attack with `torchrun --nproc_per_node=N`
and NCCL (UADA_ddp.py). Here every rank calls `initialize_multihost()`
once, before it touches a device: it reads torchrun's environment, picks
the backend by a fixed rule and pins the rank's card.

    torchrun --nproc_per_node 2 -m roboticattack_torch.cli.attack \\
        --data_parallel true ...
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class DistInfo(NamedTuple):
    backend: str
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


_INFO: Optional[DistInfo] = None


def backend_for(device_type: str, local_world_size: int, device_count: int) -> str:
    """gloo on the CPU; nccl when every local rank has a card of its own;
    gloo when the local ranks outnumber the cards (NCCL refuses two ranks
    on one device, gloo moves CUDA tensors through the host)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= device_count else "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> DistInfo:
    """Join (or form) the process group, once per process.

    torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE / LOCAL_RANK
    are honoured; explicit arguments override them. `coordinator_address`
    is "host:port" or an init URL ("tcp://...", "file://..."). Without
    either, the process forms a world of one. Each rank's device is
    cuda:(LOCAL_RANK % device_count) (`torch.cuda.set_device`), or the CPU
    with device="cpu". An init that fails raises."""
    global _INFO
    if dist.is_initialized():
        if _INFO is None:
            raise RuntimeError("torch.distributed was initialized outside initialize_multihost")
        return _INFO
    env_world, env_rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    world = num_processes if num_processes is not None else (env_world or 1)
    rank = process_id if process_id is not None else (env_rank or 0)
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    if local_rank is None:
        local_rank = rank % local_world

    dev_type = torch.device(device).type
    if dev_type == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    else:
        count = 0
        dev = torch.device("cpu")
    backend = backend_for(dev_type, local_world, count)

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise ValueError(f"a world of {world} processes needs a coordinator address (MASTER_ADDR)")
    _INFO = DistInfo(backend, rank, world, local_rank, dev)
    if rank == 0:
        print(f"torch.distributed initialized: backend {backend}, rank {rank}/{world}, device {dev}",
              flush=True)
    return _INFO


def shutdown() -> None:
    """Leave the process group initialize_multihost joined."""
    global _INFO
    if dist.is_initialized():
        dist.destroy_process_group()
    _INFO = None


def current() -> Optional[DistInfo]:
    """What initialize_multihost set up in this process, or None."""
    return _INFO if dist.is_initialized() else None
