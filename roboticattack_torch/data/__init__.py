"""Attack data of the port: the synthetic frame source and the collator."""

from .collator import batch_iterator, collate
from .dummy import dummy_frame_iterator

__all__ = ["batch_iterator", "collate", "dummy_frame_iterator"]
