"""Tracing and wall-clock step timing (the JAX package's
`utils/profiling.py`). `maybe_trace` records a block with torch.profiler
into one Chrome trace per rank; `span` and `count` mark the attack path's
layers while a profiler records, on its timeline and in memory
(`recorded_steps`), and `keep` holds a step's device tensors for them;
`tallying` sets a block's counts and kept tensors aside (a CUDA graph's
capture), and `credit` hands them to the recorder at each replay;
StepTimer's caller ends each timed step with a device
synchronize; `counting_collectives` records each collective a block makes,
with its bytes and host seconds (parallel/evidence.py's inventory)."""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block when `trace_dir` is set: host activity, and the
    card's kernels where CUDA is available, written as
    <trace_dir>/trace_rank<r>.json (Chrome trace format; r is the process
    group rank, 0 without one)."""
    if not trace_dir:
        yield
        return
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}")


class StepTimer:
    """Wall-clock per-step timing with a percentile summary."""

    def __init__(self) -> None:
        self.samples = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "steps": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "min_s": s[0],
        }


# the collectives the port calls, recorded with their tensor
COUNTED = ("all_reduce", "all_gather", "broadcast")
# every other collective of torch.distributed: recorded by name, or refused
OTHER_COLLECTIVES = (
    "all_gather_into_tensor", "all_gather_object", "all_to_all", "all_to_all_single", "barrier",
    "batch_isend_irecv", "broadcast_object_list", "gather", "gather_object", "irecv", "isend",
    "monitored_barrier", "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send",
)


class Collective(NamedTuple):
    """One collective call of this process."""

    name: str  # the torch.distributed function: all_reduce, all_gather, broadcast, or another
    op: Optional[str]  # an all_reduce's op (SUM, MAX, ...), else None
    ranks: Any  # the group's ranks (a tuple), or "world" without a group
    shape: tuple  # the tensor this rank gives (another collective's first tensor argument, or ())
    dtype: str
    nbytes: int  # of that tensor
    seconds: float  # host clock around the call; a CUDA tensor's card synchronized before and after


def _given_tensor(name: str, a: tuple, k: dict):
    """The tensor this rank gives to collective `name`: all_gather's second
    argument, else the first tensor among the arguments (or in a list of
    them), or None."""
    import torch

    if name == "all_gather":
        return a[1]
    for x in list(a) + list(k.values()):
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            if isinstance(t, torch.Tensor):
                return t
    return None


@contextlib.contextmanager
def counting_collectives(log: list) -> Iterator[list]:
    """Append a Collective to `log` for every collective of torch.distributed
    this process makes while the block runs: dist.all_reduce / all_gather /
    broadcast (COUNTED) with their tensor, any of OTHER_COLLECTIVES by name
    (with its first tensor argument, if any). The functions are replaced
    on torch.distributed for the block, so every caller that looks them up
    at call time is seen. A CUDA tensor's card is synchronized before the
    call, so its seconds leave out the work queued before it."""
    import torch
    import torch.distributed as dist

    saved = {n: getattr(dist, n) for n in COUNTED + OTHER_COLLECTIVES if hasattr(dist, n)}

    def wrap(name):
        def call(*a, **k):
            t = _given_tensor(name, a, k)
            group = k.get("group")
            ranks = tuple(dist.get_process_group_ranks(group)) if group is not None else "world"
            op = str(k.get("op", dist.ReduceOp.SUM)).split(".")[-1] if name == "all_reduce" else None
            cuda = t is not None and t.is_cuda
            if cuda:
                torch.cuda.synchronize(t.device)
            start = time.perf_counter()
            out = saved[name](*a, **k)
            if cuda:
                torch.cuda.synchronize(t.device)
            shape, dtype, nbytes = ((), "", 0) if t is None else \
                (tuple(t.shape), str(t.dtype), t.numel() * t.element_size())
            log.append(Collective(name, op, ranks, shape, dtype, nbytes, time.perf_counter() - start))
            return out
        return call

    for n in saved:
        setattr(dist, n, wrap(n))
    try:
        yield log
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


# Spans and counters. The switch is the profiler itself: while none records,
# `span` returns a shared no-op context after one flag check and `count`
# does nothing, so the traced code runs exactly as untraced code does.
_tracing = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclass
class Tally:
    """What a block counted and kept while `tallying` was open."""

    counters: Dict[str, int] = field(default_factory=dict)
    kept: Dict[str, List[torch.Tensor]] = field(default_factory=dict)


# The open tally, or None. One for the process, not a thread's: a capture's
# backward counts on the autograd engine's thread.
_TALLY: Optional[Tally] = None


@dataclass(slots=True)
class SpanRecord:
    """One span of an outer step. `parent` indexes the enclosing span in the
    step's `spans` (None for the step's own span); `recompute` says a
    backward span was open when it opened (checkpoint recomputation, on
    whichever thread the autograd engine runs it); `start_ns`/`end_ns` are
    time.time_ns stamps, the clock of the profiler's events; `events` the
    CUDA events recorded on the current stream at its edges (None off
    CUDA)."""

    name: str
    parent: Optional[int]
    step: int
    thread: int
    recompute: bool
    start_ns: int
    end_ns: Optional[int] = None
    events: Optional[Tuple[Any, Any]] = None

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def stream_ms(self) -> Optional[float]:
        """Device-stream time between the span's edges, idle time included;
        waits for the end event (call it after the traced work)."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


@dataclass
class OuterStep:
    """The spans (in the order they opened), counters and kept tensors of
    one outer step."""

    id: int
    cuda: bool
    spans: List[SpanRecord] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    # device tensors kept as they were (`keep`), read once the step is done
    kept: Dict[str, List[torch.Tensor]] = field(default_factory=dict)

    def named(self, name: str) -> List[SpanRecord]:
        return [s for s in self.spans if s.name == name]

    def host_ms(self, name: str) -> float:
        return sum(s.host_ms() for s in self.named(name))

    def stream_ms(self, name: str) -> Optional[float]:
        """The summed stream time of the spans called `name`; None when they
        recorded no CUDA events (or there are none)."""
        spans = self.named(name)
        if not spans or any(s.events is None for s in spans):
            return None
        return sum(s.stream_ms() for s in spans)


class Recorder:
    """The outer steps recorded while a profiler ran, the last `keep` of
    them. Spans and counts outside an open outer step reach the profiler's
    timeline only."""

    def __init__(self, keep: int = 8) -> None:
        self.steps: Deque[OuterStep] = deque(maxlen=keep)
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's stack of open span indices
        self._step: Optional[OuterStep] = None
        self._backward: Optional[int] = None  # the open backward span's index

    def clear(self) -> None:
        self.steps.clear()
        self._step = self._backward = None

    def open(self, name: str, backward: bool, device=None) -> Optional[tuple]:
        """Record a span's opening (a new outer step's with `device`); the
        token `close` takes, or None outside an outer step."""
        if device is not None:
            self._step = OuterStep(next(self._ids), torch.device(device).type == "cuda")
            self.steps.append(self._step)
        step = self._step
        if step is None:
            return None
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        held = self._backward
        rec = SpanRecord(name, stack[-1] if stack else held, step.id, threading.get_ident(), held is not None,
                         time.time_ns())
        if step.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, None)
        with self._lock:
            index = len(step.spans)
            step.spans.append(rec)
        stack.append(index)
        if backward:
            self._backward = index
        return rec, stack, held, backward, device is not None

    def close(self, token: tuple) -> None:
        rec, stack, held, backward, outer = token
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events = (rec.events[0], end)
        rec.end_ns = time.time_ns()
        stack.pop()
        if backward:
            self._backward = held
        if outer:
            self._step = None

    def count(self, name: str, n: int) -> None:
        step = self._step
        if step is not None:
            with self._lock:
                step.counters[name] = step.counters.get(name, 0) + n

    def keep(self, name: str, tensor: torch.Tensor) -> None:
        step = self._step
        if step is not None:
            with self._lock:
                step.kept.setdefault(name, []).append(tensor.detach())


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "backward", "device", "_fn", "_token")

    def __init__(self, name: str, backward: bool, device) -> None:
        self.name, self.backward, self.device = name, backward, device

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._token = RECORDER.open(self.name, self.backward, self.device)
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            RECORDER.close(self._token)
        self._fn.__exit__(*exc)
        return False


def span(name: str, backward: bool = False):
    """A span over a block while a profiler records: a `record_function` on
    the profiler's timeline, and a SpanRecord in the open outer step with
    CUDA events at its edges when the step runs on CUDA (never a
    synchronize). With `backward`, spans that open while it is open, on any
    thread, are flagged `recompute` (and a thread with no open span of its
    own parents them under it). With no profiler recording, or inside
    `tallying`: a no-op."""
    if not _tracing() or _TALLY is not None:
        return _OFF
    return _Span(name, backward, None)


def outer_step(name: str, device):
    """`span` that opens a new outer step of the recorder (its spans record
    CUDA events when `device` is a CUDA device)."""
    if not _tracing():
        return _OFF
    return _Span(name, False, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the open outer step's counter `name` while a profiler
    records (to the open tally's instead, inside `tallying`)."""
    tally = _TALLY
    if tally is not None:
        tally.counters[name] = tally.counters.get(name, 0) + n
    elif _tracing():
        RECORDER.count(name, n)


def keep(name: str, tensor: torch.Tensor) -> None:
    """Keep `tensor` (detached, where it lives: no copy to the host, so no
    synchronize) under `name` in the open outer step while a profiler
    records; a reader reduces the list after the step. Inside `tallying`,
    the open tally keeps it instead."""
    tally = _TALLY
    if tally is not None:
        tally.kept.setdefault(name, []).append(tensor.detach())
    elif _tracing():
        RECORDER.keep(name, tensor)


@contextlib.contextmanager
def tallying() -> Iterator[Tally]:
    """Within the block, `count` and `keep` go to a new Tally (yielded),
    whether or not a profiler records, and `span` is a no-op: the block's
    Python runs once (a CUDA graph's capture) for work that runs later."""
    global _TALLY
    saved, _TALLY = _TALLY, Tally()
    try:
        yield _TALLY
    finally:
        _TALLY = saved


def credit(tally: Tally) -> None:
    """While a profiler records, add `tally`'s counts to the open outer
    step's counters, and keep a copy of each of its kept tensors (a replay
    overwrites them), as if the tallied block had run again."""
    if _tracing():
        for name, n in tally.counters.items():
            RECORDER.count(name, n)
        for name, tensors in tally.kept.items():
            for t in tensors:
                RECORDER.keep(name, t.clone())


def recorded_steps() -> List[OuterStep]:
    """The outer steps recorded so far (the last few), oldest first."""
    return list(RECORDER.steps)
