"""What the 7B-shape audit tests (test_torch_multichip_7b_shapes_*.py) hold
the port's audit (roboticattack_torch/parallel/evidence.py) against: the
JAX package's per-device shard of each leaf of the same layout, from
`abstract_params` (jax.eval_shape and each leaf's sharding.shard_shape; no
program is compiled), and a rank's collectives by kind."""

import functools

import jax
import numpy as np

from roboticattack_tpu.models import init_vla_params
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.parallel.evidence import abstract_params, evidence_7b_config
from roboticattack_tpu.parallel.sharding import vla_param_specs

MB = 1 << 20
KB = 1 << 10


@functools.lru_cache(maxsize=None)
def jax_device_leaves(dp: int, tp: int, cooked: bool = False, quantize=False, shard_projector: bool = False) -> dict:
    """path -> (shape, dtype name) of one device's shard of each leaf of
    JAX's layout on a dp x tp mesh (`quantize`: abstract_params' True for
    int8, or 'int4'; `shard_projector`: the storage layout with the
    projector cut, vla_param_specs' own option)."""
    cfg = evidence_7b_config()
    mesh = jmake_mesh(data=dp, model=tp, devices=jax.devices()[:dp * tp])
    specs = None
    if shard_projector:
        shapes = jax.eval_shape(lambda k: init_vla_params(k, cfg), jax.random.key(0))
        specs = vla_param_specs(shapes, shard_projector=True)
    tree = abstract_params(cfg, mesh, specs=specs, cooked=cooked, quantize=quantize)
    return {tuple(k.key for k in path): (tuple(s.sharding.shard_shape(s.shape)), str(s.dtype))
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def leaf_bytes(shape, dtype: str) -> int:
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(jax.numpy.dtype(dtype)).itemsize


def assert_params_equal_jax(audit, dp: int, tp: int, cooked: bool = False, quantize=False,
                            shard_projector: bool = False) -> int:
    """Every leaf of the audited rank has the shape and dtype of JAX's
    per-device shard of it, and the two trees have the same leaves: the
    rank's parameter bytes equal JAX's exactly. Returns them."""
    want = jax_device_leaves(dp, tp, cooked, quantize, shard_projector)
    got = {path: (tuple(x.shape), str(x.dtype).split(".")[-1]) for path, x in audit.params.items()}
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    differ = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    assert not differ, differ
    total = sum(leaf_bytes(*v) for v in want.values())
    assert sum(x.numel() * x.element_size() for x in audit.params.values()) == total
    return total


def by_kind(audit, classify) -> dict:
    """The audit's collectives counted by `classify(collective)`, which
    names each one's kind or returns None for one the design does not
    make (an assertion error then)."""
    kinds = {}
    for c in audit.collectives:
        kind = classify(c)
        assert kind is not None, c
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds
