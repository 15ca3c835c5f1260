"""The program's expert choices, as the sparse-expert driver reads and sets
them.

`taken` collects every choice that the program's sparse-expert layers make
while it is open: the [T, k] index tensor of
`models/deepseek.choose_experts`, left where it is (no copy, no
synchronize), in the order made. A forward makes one a sparse layer; the
recomputation in the backward reuses the forward's.

`balance` sets the correction bias `e_bias` as DeepSeek-V3 trains it
(auxiliary-loss-free balancing: after each batch an overloaded expert's
bias falls by a step and an underloaded one's rises by it), here on seeded
frames, with a step that shrinks from round to round. Random weights
otherwise send most tokens to a few experts; a trained model's learned
bias keeps the load near even, and so does this one. The bias chooses
experts and does not weigh them.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict, Iterator, List

import torch

from roboticattack_torch.models import deepseek

ROUNDS = 40
FIRST_STEP, LAST_STEP = 0.05, 0.001


@contextlib.contextmanager
def taken() -> Iterator[List[torch.Tensor]]:
    """A list that receives each expert choice the program makes while the
    block runs."""
    got: List[torch.Tensor] = []
    choose = deepseek.choose_experts

    def choose_and_keep(*args):
        idx = choose(*args)
        got.append(idx)
        return idx

    deepseek.choose_experts = choose_and_keep
    try:
        yield got
    finally:
        deepseek.choose_experts = choose


def loads(chosen: List[torch.Tensor], experts: int) -> torch.Tensor:
    """[layers, experts] float: each sparse layer call's routed rows by
    expert."""
    return torch.stack([torch.bincount(i.reshape(-1), minlength=experts) for i in chosen]).float()


def max_over_mean(load: torch.Tensor) -> float:
    """The busiest expert's rows over the mean, averaged over the layers."""
    return float((load.amax(dim=-1) / load.mean(dim=-1)).mean())


@torch.no_grad()
def balance(params: Dict, forward: Callable[[], None], chosen: List[torch.Tensor]) -> Dict[str, float]:
    """Sets params' `e_bias` [layers, experts] in place: ROUNDS times, one
    `forward()` (a new batch each) with `chosen` open (`taken`), then each
    layer's bias moved by the round's step towards the mean load. The step
    falls geometrically from FIRST_STEP to LAST_STEP. Returns the busiest
    expert over the mean in the first round and in the last."""
    e_bias = params["llm"]["moe"]["e_bias"]
    layers, experts = e_bias.shape
    ratio = (LAST_STEP / FIRST_STEP) ** (1.0 / (ROUNDS - 1))
    seen = {}
    for r in range(ROUNDS):
        start = len(chosen)
        forward()
        if len(chosen) - start != layers:
            raise RuntimeError(f"a forward made {len(chosen) - start} expert choices, not one a sparse layer "
                               f"({layers})")
        load = loads(chosen[start:], experts)
        del chosen[start:]
        if r == 0:
            seen["first"] = max_over_mean(load)
        if r == ROUNDS - 1:
            seen["last"] = max_over_mean(load)
        e_bias += FIRST_STEP * ratio ** r * torch.sign(load.mean(dim=-1, keepdim=True) - load)
    print(f"routing balanced in {ROUNDS} rounds: busiest expert over the mean {seen['first']:.3f} -> "
          f"{seen['last']:.3f}", file=sys.stderr)
    return seen
