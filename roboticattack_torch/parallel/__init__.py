"""The data-parallel attack's process group and data axis (the JAX
package's `parallel/`). Tensor-parallel serving (`make_serving_mesh`,
`shard_params`) is not ported yet."""

from .distributed import DistInfo, backend_for, initialize_multihost
from .mesh import (
    DataMesh,
    all_gather_rows,
    all_reduce_sum,
    broadcast_object,
    make_mesh,
    patch_digest,
    process_zero,
    replicate,
    shard_batch,
)
