"""Process groups and meshes (the JAX package's `parallel/`): the
data-parallel attack's data axis, and the dp x tp grid of tensor- and
data-parallel serving with the Megatron splits of the weights."""

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
    shard_params,
    vla_param_specs,
)
