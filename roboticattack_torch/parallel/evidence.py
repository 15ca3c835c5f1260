"""The 7B's tensor- and data-parallel layout, audited without weights and
without a card (the JAX package's `parallel/evidence.py`).

JAX lowers the full-shape programs with abstract parameters on a virtual
mesh and reads the compiled result: each device's argument bytes and the
collective inventory of the optimized HLO. Here the program is the port's
own Python and each rank is a process, so the audit runs one rank's path at
a time, in this process: on the meta device (shapes and dtypes, no
storage), under a fake process group of the layout's world size
(torch.testing's `fake` backend, whose collectives return at once and move
nothing), on the grid make_mesh / make_serving_mesh build
(parallel/mesh.py `grid_mesh`). `utils.profiling.counting_collectives`
records every collective the rank issues, in the place of JAX's HLO parser,
and the audit fails if any is other than all_reduce, all_gather and broadcast.
The rank's parameters come through the load path of the card
(models.vlm.iter_vla_params -> parallel.sharding.shard_leaves for the
attack's storage layout, shard_decode_leaves for the decode's cooked and
quantized one), so their bytes are the rank's own.

As in JAX's evidence, attention is the chunked one in place of the flash
kernels (B1/B2) and the decode runs with the int4 kernel (B4) off: no
kernel runs on meta, and none issues a collective. The host reads of the
path have a meta branch: the Jacobi decode runs every pass up to its n - 1
bound and issues each pass's MAX flag (models/decode.py, ServingMesh.
any_rank), JAX's while_loop program. The patch draws are host data, as on
the card.

No counterpart: `collect_collectives` (there is no HLO; the recorded calls
are the inventory) and `tpu_topology_mesh` (there is no TPU topology).
`memory_summary` gives the rank's argument bytes and no temporaries: JAX's
CPU temps were not a device's, and the card measures real peaks
(chip_smoke.py).

    python -m roboticattack_torch.parallel.evidence

prints one JSON line per configuration of CONFIGS, for rank 0 and for the
last rank of its layout. It needs no card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import VLAConfig, get_config, torch_dtype
from ..models.param_tree import tree_from_leaves, tree_leaves
from ..utils.profiling import COUNTED, Collective, counting_collectives
from .mesh import DataMesh, ServingMesh, grid_mesh, serving_mesh, shard_batch, world_mesh

META = torch.device("meta")
GB = 1024 ** 3  # JAX's argument_gb unit


class Audit(NamedTuple):
    """One rank's path on meta: its leaves (path -> tensor), its inputs and
    state (the attack's AdamW state; empty for a decode), and the
    collectives it issued, in order."""

    dp: int
    tp: int
    rank: int
    params: Dict[Tuple[str, ...], torch.Tensor]
    inputs: Tuple[torch.Tensor, ...]
    state: Tuple[torch.Tensor, ...]
    collectives: List[Collective]


def evidence_config(cfg: VLAConfig) -> VLAConfig:
    """`cfg` with chunked attention in the LLM (the flash kernels cannot run
    on meta; their collectives are the same: none)."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="chunked"))


def evidence_7b_config(name: str = "openvla-7b") -> VLAConfig:
    return evidence_config(get_config(name))


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A fake process group of `world` ranks in which this process is
    `rank`, destroyed on the way out, also on error. Raises if a process
    group is already initialized, and ImportError without torch.testing's
    fake backend (no fallback)."""
    if dist.is_initialized():
        raise RuntimeError("the audit forms its own process group; this process has one initialized")
    # private to torch: the import registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_place(dp: int, tp: int, rank: int) -> None:
    if dp < 1 or tp < 1 or not 0 <= rank < dp * tp:
        raise ValueError(f"rank {rank} of a dp {dp} x tp {tp} grid")


def attack_mesh(dp: int, tp: int) -> Optional[DataMesh]:
    """The rank's mesh as make_mesh(data=dp, model=tp) gives it, on meta:
    None for one rank, the whole world as the data axis at tp 1."""
    if dp * tp == 1:
        return None
    return world_mesh(META) if tp == 1 else grid_mesh(dp, tp, META)


def decode_mesh(dp: int, tp: int) -> Optional[ServingMesh]:
    """The rank's mesh as make_serving_mesh(tp, dp) gives it, on meta."""
    return None if dp * tp == 1 else serving_mesh(grid_mesh(dp, tp, META))


def rank_params(cfg: VLAConfig, mesh=None, cooked: bool = False, quantize: Optional[str] = None,
                shard_projector: bool = False) -> Dict[Tuple[str, ...], torch.Tensor]:
    """This rank's leaves (path -> meta tensor) through the load path of
    the card: the storage layout (shard_leaves, `shard_projector` as the
    attack takes it), or with `cooked` the decode layout
    (shard_decode_leaves), weight-quantized by `quantize` ('int8', 'int4',
    'int4:<gs>', 'w8a8'; int4's group by int4_group_size_for(cfg, tp))."""
    from ..models.quant import int4_group_size_for
    from ..models.vlm import iter_vla_params
    from ..utils.quant_args import resolve_quantize
    from .sharding import shard_decode_leaves, shard_leaves

    leaves = iter_vla_params(torch.Generator().manual_seed(0), cfg, device=META)
    tp = mesh.tp if mesh is not None else 1
    if not cooked:
        if quantize is not None:
            raise ValueError("quantize applies to the decode layout (cooked=True)")
        mesh = mesh or DataMesh(group=None, rank=0, size=1, device=META)
        return dict(shard_leaves(leaves, mesh, shard_projector=shard_projector))
    mode, _, gs = resolve_quantize(quantize)
    if mode == "int4" and gs is None:
        gs = int4_group_size_for(cfg, tp=tp)
    mesh = mesh or ServingMesh(tp=1, dp=1, rank=0, device=META)
    return dict(tree_leaves(shard_decode_leaves(leaves, mesh, quant=mode, group_size=gs)))


def rank_attack_inputs(mesh, batch_size: int, pad_to: int, image_size: int = 224,
                       patch_hw: Tuple[int, int] = (50, 50)):
    """(state, batch) of make_attack_step's signature on meta: the rank's
    replica's rows of the global batch (shard_batch), and the attack state
    (patch, AdamW moments and count, accumulation buffer) whole on every
    rank, as the attacker places them."""
    from ..attacks import engine

    def rows(*shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device=META)

    batch = engine.AttackBatch(rows(batch_size, image_size, image_size, 3, dtype=torch.float32),
                               rows(batch_size, pad_to), rows(batch_size, pad_to), rows(batch_size, pad_to))
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    return engine.init_attack_state(None, patch_hw, META), batch


def audit_attack_step(cfg: VLAConfig, dp: int, tp: int, rank: int, batch_size: int = 8, pad_to: int = 32,
                      objective: str = "uada", inner_loop: int = 2, shard_projector: bool = False,
                      maskidx: Sequence[int] = tuple(range(7)), patch_hw: Tuple[int, int] = (50, 50),
                      apply_update: bool = True) -> Audit:
    """Rank `rank`'s attack step (make_attack_step(..., mesh), `inner_loop`
    inner steps on the global batch's draws) of a dp x tp grid, on meta."""
    from ..attacks import engine
    from ..utils.labels import build_tma_target_tokens

    _check_place(dp, tp, rank)
    cfg = evidence_config(cfg)
    spec = engine.AttackSpec(objective=objective, inner_loop=inner_loop)
    target = build_tma_target_tokens(np.zeros(7), list(maskidx)) if objective == "tma" else None
    size = cfg.dino.image_size
    draws = engine.draw_step(torch.Generator().manual_seed(0), spec, (batch_size, size, size, 3), patch_hw,
                             (batch_size, pad_to))
    log: List[Collective] = []
    with fake_world(dp * tp, rank):
        mesh = attack_mesh(dp, tp)
        params = rank_params(cfg, mesh, shard_projector=shard_projector)
        state, batch = rank_attack_inputs(mesh, batch_size, pad_to, size, patch_hw)
        step = engine.make_attack_step(spec, cfg, target, list(maskidx), mesh)
        with counting_collectives(log):
            step(tree_from_leaves(params.items()), state, batch, 2e-3, apply_update, draws)
    _only_counted(log)
    return Audit(dp, tp, rank, params, tuple(batch), _flat(state), log)


def audit_attack_step_7b(dp: int, tp: int, rank: int, **kw) -> Audit:
    """audit_attack_step on the 7B (evidence_7b_config); bs 8 and pad 32
    (S = 288) by default, the 7B's attack envelope."""
    return audit_attack_step(evidence_7b_config(), dp, tp, rank, **kw)


def audit_decode(cfg: VLAConfig, dp: int, tp: int, rank: int, batch_size: int = 8, prompt_pad: int = 64,
                 quantize: Optional[str] = None, kv_cache: Optional[str] = None, jacobi: bool = False,
                 visual_tokens: Optional[int] = None, act_quant: Optional[str] = None) -> Audit:
    """Rank `rank`'s serving decode (greedy_decode_actions on the cooked
    weights, `quantize` as rank_params takes it, the int4 kernel off) of
    its replica's rows of a global batch of `batch_size`, on meta. `jacobi`
    decodes with a draft of zeros: every pass runs."""
    from ..models.decode import greedy_decode_actions
    from ..utils.constants import ACTION_DIM

    _check_place(dp, tp, rank)
    if batch_size % dp:
        raise ValueError(f"a batch of {batch_size} rows does not split over {dp} replicas")
    cfg = evidence_config(cfg)
    b, size = batch_size // dp, cfg.dino.image_size
    inputs = (torch.empty((b, prompt_pad), dtype=torch.int32, device=META),
              torch.empty((b, prompt_pad), dtype=torch.int32, device=META),
              torch.empty((b, 2, size, size, 3), dtype=torch_dtype(cfg), device=META))
    draft = torch.zeros((b, ACTION_DIM), dtype=torch.int32, device=META) if jacobi else None
    log: List[Collective] = []
    with fake_world(dp * tp, rank):
        mesh = decode_mesh(dp, tp)
        params = rank_params(cfg, mesh, cooked=True, quantize=quantize)
        with counting_collectives(log), torch.inference_mode():
            greedy_decode_actions(tree_from_leaves(params.items()), cfg, *inputs, cooked_weights=True, mesh=mesh,
                                  kv_cache=kv_cache, draft_tokens=draft, visual_tokens=visual_tokens,
                                  act_quant=act_quant, int4_kernel=False)
    _only_counted(log)
    return Audit(dp, tp, rank, params, inputs + (() if draft is None else (draft,)), (), log)


def audit_decode_7b(dp: int, tp: int, rank: int, **kw) -> Audit:
    """audit_decode on the 7B (evidence_7b_config); bs 8 and a prompt of
    64 (a prefill of 320) by default."""
    return audit_decode(evidence_7b_config(), dp, tp, rank, **kw)


def _only_counted(log: Sequence[Collective]) -> None:
    others = sorted({c.name for c in log if c.name not in COUNTED})
    if others:
        raise RuntimeError(f"torch.distributed.{', '.join(others)}: a collective other than {', '.join(COUNTED)}")


def _flat(tree) -> Tuple[torch.Tensor, ...]:
    if isinstance(tree, torch.Tensor):
        return (tree,)
    return tuple(t for x in tree for t in _flat(x))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def memory_summary(audit: Audit) -> Dict[str, float]:
    """The rank's argument bytes: its parameters, inputs and state, and
    their sum in GiB as `argument_gb` (JAX's unit, 1024**3)."""
    p, i, s = _nbytes(audit.params.values()), _nbytes(audit.inputs), _nbytes(audit.state)
    return {"param_bytes": p, "input_bytes": i, "state_bytes": s, "argument_gb": (p + i + s) / GB}


def inventory(collectives: Sequence[Collective]) -> collections.Counter:
    """The multiset of (name, op, group ranks, shape, dtype) of a
    collective log (an audit's, or a rank's counting_collectives log)."""
    return collections.Counter((c.name, c.op, c.ranks, tuple(c.shape), c.dtype) for c in collectives)


def collective_summary(audit: Audit) -> List[Dict]:
    """The inventory grouped, largest tensor first: [{name, op, ranks,
    shape, dtype, nbytes_per_rank, count}]."""
    nbytes = {(c.name, c.op, c.ranks, tuple(c.shape), c.dtype): c.nbytes for c in audit.collectives}
    return [{"name": k[0], "op": k[1], "ranks": k[2], "shape": list(k[3]), "dtype": k[4],
             "nbytes_per_rank": nbytes[k], "count": n}
            for k, n in sorted(inventory(audit.collectives).items(), key=lambda kv: -nbytes[kv[0]])]


# The nine configurations of the JAX package's tests/test_multichip_7b_shapes.py:
# (name, audit function, dp, tp, options)
CONFIGS = [
    ("attack_dp4_tp2", audit_attack_step_7b, 4, 2, {}),
    ("attack_dp8", audit_attack_step_7b, 8, 1, {}),
    ("decode_tp2", audit_decode_7b, 1, 2, {}),
    ("decode_int8_bs8", audit_decode_7b, 1, 1, {"quantize": "int8"}),
    ("decode_int4_bs16", audit_decode_7b, 1, 1, {"quantize": "int4", "batch_size": 16}),
    ("decode_int4_tp2_bs16", audit_decode_7b, 1, 2, {"quantize": "int4", "batch_size": 16}),
    ("decode_jacobi_tp2", audit_decode_7b, 1, 2, {"jacobi": True}),
    ("decode_w8a8_tp2_bs16", audit_decode_7b, 1, 2, {"quantize": "int8", "act_quant": "int8", "batch_size": 16}),
    ("decode_int8_dp2", audit_decode_7b, 2, 1, {"quantize": "int8"}),
]


def main() -> int:
    for name, fn, dp, tp, kw in CONFIGS:
        for rank in sorted({0, dp * tp - 1}):
            audit = fn(dp, tp, rank, **kw)
            print(json.dumps({"config": name, "dp": dp, "tp": tp, "rank": rank, "options": kw,
                              "memory": memory_summary(audit), "collectives": collective_summary(audit)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
