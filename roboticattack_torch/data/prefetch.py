"""Overlap batch assembly and the host->device copy with the step.

`host_prefetch` runs the host side (tf.data or the native reader, tokenize,
pad, collate) on a daemon thread, as the JAX package's does.
`device_prefetch` moves batches to the card ahead of use: each batch is
copied into pinned host memory and sent on a side CUDA stream, and the
consumer's stream waits on the copy's event before it touches the tensors.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator

import numpy as np
import torch


def host_prefetch(batches: Iterator, depth: int = 2) -> Iterator:
    """Overlap HOST batch assembly with device compute: a daemon thread pulls
    `batches` into a bounded queue, in order; a producer error is raised at
    the consumer. Works even on a 1-core host: the consumer sleeps in the
    device synchronize (GIL released) while the feeder assembles the next
    batch. Closing the consumer (or dropping it) stops the feeder after the
    batch it is assembling."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def worker():
        try:
            for batch in batches:
                q.put(batch)
                if stop.is_set():
                    return
        except Exception as e:  # surface producer errors at the consumer
            q.put(e)
            return
        q.put(sentinel)

    threading.Thread(target=worker, daemon=True, name="host-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # free a slot for a feeder blocked in put()
            q.get_nowait()


def _map(fn, tree):
    """`fn` over the array leaves of dicts, lists, tuples and namedtuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def device_prefetch(batches: Iterator, depth: int = 2, device="cuda") -> Iterator:
    """Yield the batches of `batches` with every array leaf a tensor on
    `device`, in order, keeping up to `depth` copies in flight. On CUDA each
    leaf is pinned and copied on a side stream; the consumer's current
    stream waits on the copy's event, and each tensor is `record_stream`ed
    to it so the allocator keeps its memory until the consumer's work is
    done. On the CPU the leaves are only converted."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield _map(torch.as_tensor, batch)
        return
    side = torch.cuda.Stream(device)
    pending = collections.deque()

    def start(batch):
        with torch.cuda.stream(side):
            moved = _map(lambda a: torch.as_tensor(a).pin_memory().to(device, non_blocking=True),
                         batch)
            done = torch.cuda.Event()
            done.record(side)
        pending.append((moved, done))

    it = iter(batches)
    for batch in it:
        start(batch)
        if len(pending) >= depth:
            break
    while pending:
        moved, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        _map(lambda t: t.record_stream(consumer), moved)
        for batch in it:
            start(batch)
            break
        yield moved
