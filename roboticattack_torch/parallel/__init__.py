"""Process groups and meshes (the JAX package's `parallel/`): the (data,
model) grid of the attack step (`make_mesh`) and of tensor- and
data-parallel serving (`make_serving_mesh`), the Megatron splits of the
weights (`sharding`) and the attack's model-axis collectives
(`tensor_parallel`)."""

from .distributed import DistInfo, backend_for, initialize_multihost
from .mesh import (
    DataMesh,
    ServingMesh,
    all_gather_rows,
    all_reduce_sum,
    batch_sharding,
    broadcast_object,
    make_mesh,
    make_serving_mesh,
    patch_digest,
    process_zero,
    replicate,
    replicated,
    shard_batch,
)
from .sharding import (
    PartitionSpec,
    decode_param_specs,
    llama_param_specs,
    shard_decode_leaves,
    shard_decode_params,
    shard_leaves,
    shard_params,
    vla_leaf_spec,
    vla_param_specs,
)
