"""The port's prefetch (`data/prefetch.py`) and the runner's staging:
`host_prefetch` against the JAX package's (order, producer errors raised at
the consumer) and its stop on close; `device_prefetch` converting on the
CPU and, on the card (cuda-marked), moving batches bit-equal through pinned
memory and a side stream; the pinned, non-blocking `batch_to_device` equal
to the blocking one. Tolerance: exact.

The JAX package is imported inside the tests that need it, so the
cuda-marked test also runs on the card's machine, which has no JAX
(`-m cuda --noconftest`)."""

import threading
import time

import numpy as np
import pytest
import torch

from roboticattack_torch.attacks.engine import AttackBatch, batch_to_device
from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
from roboticattack_torch.data.prefetch import device_prefetch, host_prefetch
from roboticattack_torch.utils.prompting import WordStubTokenizer


def numbered(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.float32), "i": i}


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_host_prefetch_keeps_order_as_jax(depth):
    from roboticattack_tpu.data.prefetch import host_prefetch as jhost_prefetch

    got = [b["i"] for b in host_prefetch(numbered(12), depth=depth)]
    want = [b["i"] for b in jhost_prefetch(numbered(12), depth=depth)]
    assert got == want == list(range(12))


def test_host_prefetch_raises_producer_errors_at_the_consumer():
    def failing():
        yield 0
        yield 1
        raise KeyError("bad record")

    from roboticattack_tpu.data.prefetch import host_prefetch as jhost_prefetch

    for fn in (host_prefetch, jhost_prefetch):
        seen = []
        with pytest.raises(KeyError, match="bad record"):
            for item in fn(failing(), depth=2):
                seen.append(item)
        assert seen == [0, 1]


def test_host_prefetch_stops_its_feeder_when_closed():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield i
            i += 1

    before = set(threading.enumerate())
    it = host_prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    feeder = [t for t in threading.enumerate() if t not in before and t.name == "host-prefetch"]
    assert len(feeder) == 1
    it.close()
    feeder[0].join(timeout=10)
    assert not feeder[0].is_alive()
    n = len(pulled)
    time.sleep(0.05)
    assert len(pulled) == n <= 3 + 2 + 2  # consumed + queued + the one being assembled


def dummy_batches(seed=0):
    return batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=32, seed=seed), 2, pad_to=40)


def test_device_prefetch_on_the_cpu_converts_in_order():
    src = dummy_batches()
    want = [next(src) for _ in range(4)]
    src = dummy_batches()
    got = list(device_prefetch((next(src) for _ in range(4)), depth=2, device="cpu"))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert isinstance(g, AttackBatch)
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
    nested = list(device_prefetch(numbered(3), device="cpu"))
    assert [int(b["x"][0, 0]) for b in nested] == [0, 1, 2] and nested[2]["i"] == 2


def test_pinned_non_blocking_batch_to_device_equals_blocking():
    batch = next(dummy_batches(3))
    for a, b in zip(batch_to_device(batch, "cpu", non_blocking=True), batch_to_device(batch, "cpu")):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_device_prefetch_on_the_card_is_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = dummy_batches(5)
    host = [next(src) for _ in range(6)]
    got = list(device_prefetch(iter(host), depth=3, device="cuda"))
    torch.cuda.synchronize()
    assert len(got) == 6
    for g, w in zip(got, host):
        for a, b in zip(g, w):
            assert a.device.type == "cuda"
            np.testing.assert_array_equal(a.cpu().numpy(), b)
    placed = batch_to_device(host[0], "cuda", non_blocking=True)
    for a, b in zip(placed, batch_to_device(host[0], "cpu")):
        assert torch.equal(a.cpu(), b)
