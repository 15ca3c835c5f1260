"""Attack data of the port: the synthetic frame source, the collator, the
RLDS pipeline (tfrecord and native C++ file layers), the OXE registry and
transforms, and prefetch to the card."""

from .collator import batch_iterator, collate
from .dummy import dummy_frame_iterator
from .prefetch import device_prefetch, host_prefetch
from .rlds import (
    dataset_image_key,
    load_tfds_trajectories,
    load_tfrecord_trajectories,
    make_attack_iterators,
    make_frame_dataset,
)

# Importing the registry populates rlds.STANDARDIZATION_TRANSFORMS with all
# ~70 OXE datasets (side-effect registration) so make_frame_dataset finds the
# right transform without callers importing oxe_registry themselves. tf stays
# a lazy import inside the transforms.
from .oxe_registry import (  # noqa: E402
    OXE_DATASET_CONFIGS,
    OXE_NAMED_MIXTURES,
    make_interleaved_mixture_kwargs,
    make_oxe_dataset_kwargs,
    register_oxe_dataset,
)

__all__ = [
    "OXE_DATASET_CONFIGS", "OXE_NAMED_MIXTURES", "batch_iterator", "collate", "dataset_image_key",
    "device_prefetch", "dummy_frame_iterator", "host_prefetch", "load_tfds_trajectories",
    "load_tfrecord_trajectories", "make_attack_iterators", "make_frame_dataset",
    "make_interleaved_mixture_kwargs", "make_oxe_dataset_kwargs", "register_oxe_dataset",
]
