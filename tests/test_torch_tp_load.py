"""The port's weight load and its storage-layout shards, on the CPU.

- the load, from seeded weights or from a checkpoint directory, through one
  process's `VLAPolicy` and a tp=2 rank's, holds no more than one full
  stacked LLM leaf at a time (the live tensors counted as each stack is
  drawn or stacked), and gives the cut of the reference tree
  quantize_decode_params(decode_layout_params(...));
- `load_checkpoint_dir` is the tree of `iter_checkpoint_leaves`;
- `shard_params`, `batch_sharding` and `replicated` equal the JAX
  package's shardings on its (data, model) mesh of host devices."""

import gc

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jinit_vla_params
from roboticattack_tpu.parallel import batch_sharding as j_batch_sharding
from roboticattack_tpu.parallel import make_mesh as jmake_mesh
from roboticattack_tpu.parallel import replicated as j_replicated
from roboticattack_tpu.parallel.sharding import shard_params as j_shard_params
from roboticattack_torch.eval.policy import VLAPolicy
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.convert import cast_tree, iter_checkpoint_leaves, load_checkpoint_dir
from roboticattack_torch.models.param_tree import tree_from_leaves, tree_leaves
from roboticattack_torch.models.vlm import init_vla_params, iter_vla_params
from roboticattack_torch.parallel import ServingMesh, batch_sharding, replicated, shard_params
from roboticattack_torch.parallel import sharding as tsharding
from roboticattack_torch.utils.prompting import WordStubTokenizer
from torch_tp_workers import STATS, quantized_tree

GS = 32  # int4_group_size_for(VLA_TINY, tp=2)
_LLM = VLA_TINY.llm
# the storage-layout shapes of the LLM's projection stacks: q/k/v/o, gate/up, down
FULL_STACKS = {
    (_LLM.num_layers, _LLM.hidden_size, _LLM.num_heads * _LLM.head_dim),
    (_LLM.num_layers, _LLM.hidden_size, _LLM.intermediate_size),
    (_LLM.num_layers, _LLM.intermediate_size, _LLM.hidden_size),
}


def _stack_storages() -> set:
    """The storages of every live float tensor shaped as a full stack."""
    return {o.untyped_storage().data_ptr() for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.is_floating_point() and tuple(o.shape) in FULL_STACKS}


def _counting(fn, alive: list, before: set, shape_of=None):
    """`fn`, recording before each call that makes a full stack how many
    full stacks are alive already."""
    def call(*a, **k):
        if shape_of is None or tuple(shape_of(*a)) in FULL_STACKS:
            alive.append(len(_stack_storages() - before))
        return fn(*a, **k)
    return call


@pytest.fixture(scope="module")
def seeded():
    return init_vla_params(torch.Generator().manual_seed(3), VLA_TINY)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory, seeded):
    """The seeded weights as a bf16 checkpoint directory: the float32
    config's load then casts every leaf it reads."""
    root = tmp_path_factory.mktemp("tp_load_ckpt")
    chip_smoke.export_checkpoint(cast_tree(seeded, torch.bfloat16), VLA_TINY, str(root), "vla-tiny", STATS)
    return root


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("source", ["seeded", "checkpoint"])
def test_the_load_holds_one_full_stack_at_a_time(monkeypatch, seeded, ckpt_dir, source, tp):
    """When the load draws or stacks a projection stack, no other full stack
    is alive: the one before it was cut and dropped (and, from the bf16
    checkpoint, its bf16 original too)."""
    from roboticattack_torch.models import convert, llama

    if source == "seeded":
        want = seeded
    else:
        want = cast_tree(load_checkpoint_dir(str(ckpt_dir), VLA_TINY, "cpu"), torch.float32)
    alive, before = [], _stack_storages()
    if source == "seeded":
        monkeypatch.setattr(llama, "_normal", _counting(llama._normal, alive, before, lambda gen, shape, *a: shape))
        leaves = iter_vla_params(torch.Generator().manual_seed(3), VLA_TINY)
    else:
        monkeypatch.setattr(convert, "stack", _counting(convert.stack, alive, before))
        leaves = iter_checkpoint_leaves(str(ckpt_dir), VLA_TINY, "cpu", torch.float32)
    mesh = ServingMesh(tp=tp, dp=1, rank=1, device=torch.device("cpu")) if tp > 1 else None
    policy = VLAPolicy(leaves, VLA_TINY, WordStubTokenizer(), STATS, quantize=f"int4:{GS}", device="cpu",
                       mesh=mesh)
    # the seeded load draws the 7 projection stacks; the checkpoint's stacks
    # every stacked leaf, the vision towers' too
    assert len(alive) >= 7 and not any(alive), alive
    ref = quantized_tree(want, "int4", GS)
    specs = dict(tree_leaves(tsharding.decode_param_specs(ref)))
    got = dict(tree_leaves(policy.model.tree()))
    assert got.keys() == specs.keys()
    for path, full in tree_leaves(ref):
        cut = tsharding.take_shard(full, tsharding.split_dim(specs[path]), 1, tp) if tp > 1 else full
        assert got[path].dtype == full.dtype and torch.equal(got[path], cut), path


def test_load_checkpoint_dir_is_the_tree_of_its_leaves(ckpt_dir):
    got = load_checkpoint_dir(str(ckpt_dir), VLA_TINY, "cpu")
    leaves = list(iter_checkpoint_leaves(str(ckpt_dir), VLA_TINY, "cpu"))
    assert [p for p, _ in tree_leaves(got)] == [p for p, _ in leaves]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(got), leaves))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(tree_from_leaves(leaves)), tree_leaves(got)))


# ---------------------------------------------------- storage-layout shards


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jax.jit(lambda k: jinit_vla_params(k, J_TINY))(jax.random.key(0)))


@pytest.mark.parametrize("shard_projector", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_equals_jax(jparams, tp, shard_projector):
    """Each model rank's leaves are the slices JAX's shard_params places on
    the devices of that model index."""
    jmesh = jmake_mesh(data=1, model=tp, devices=jax.devices()[:tp])
    placed = dict((tuple(k.key for k in p), x) for p, x in jax.tree_util.tree_flatten_with_path(
        j_shard_params(jparams, jmesh, shard_projector=shard_projector))[0])
    tparams = params_from_jax(jparams)
    for m in range(tp):
        got = dict(tree_leaves(shard_params(tparams, ServingMesh(tp=tp, dp=1, rank=m, device=torch.device("cpu")),
                                            shard_projector=shard_projector)))
        assert got.keys() == placed.keys()
        for path, arr in placed.items():
            index = arr.sharding.devices_indices_map(arr.shape)[jmesh.devices[0, m]]
            want = np.asarray(arr)[index]
            assert got[path].is_contiguous() and got[path].shape == want.shape, path
            np.testing.assert_array_equal(got[path].numpy(), want, err_msg=str(path))


def test_batch_sharding_and_replicated_equal_jax():
    jmesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    mesh = ServingMesh(tp=2, dp=2, rank=0, device=torch.device("cpu"))
    assert tuple(batch_sharding(mesh)) == tuple(j_batch_sharding(jmesh).spec) == ("data",)
    assert tuple(replicated(mesh)) == tuple(j_replicated(jmesh).spec) == ()
