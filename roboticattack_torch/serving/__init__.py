"""Serving layer: dynamic request batching over the batch-native decode, and
an HTTP front end."""

from .batcher import ActResult, DynamicBatcher, default_buckets
from .http import ActionServer, make_server

__all__ = ["ActResult", "ActionServer", "DynamicBatcher", "default_buckets", "make_server"]
