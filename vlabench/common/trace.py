"""The device trace of a traced run, reduced to what the per-layer readers
and the breakdown read.

`DeviceTrace` runs `torch.profiler` over a stretch of work that the driver
chooses, with the card synchronized at both ends, and reduces the events:
- the device intervals: every kernel, copy and memset on the card, merged
  into their union, whose length is the busy time;
- device time by kernel name;
- the idle gaps between the union's intervals, each named by what the host
  was doing at the gap's middle: the innermost CPU event open then (an
  operator, a runtime call, or a span of the benchmark's own loop).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[int, float]]  # kernel name -> (launches, device seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host activity, seconds), longest first

    def seconds_matching(self, words) -> float:
        return sum(t for name, (_, t) in self.by_name.items() if any(w in name.lower() for w in words))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(((n, t) for n, (_, t) in self.by_name.items()), key=lambda kv: -kv[1])[:top]
        by_host: Dict[str, float] = {}
        for name, s in self.gaps:
            by_host[name] = by_host.get(name, 0.0) + s
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": [[n[:200], t] for n, t in gaps]}


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals covering `spans`."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def name_gaps(busy: List[Tuple[float, float]], host: List[Tuple[float, float, str]],
              lo: float, hi: float) -> List[Tuple[str, float]]:
    """The idle stretches of [lo, hi] outside `busy` (microseconds), each
    named by the innermost (latest-starting) host event open at its middle;
    "host: no event" where none is. `host` is sorted by start."""
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    starts = [h[0] for h in host]
    long = [h for h in host if h[1] - h[0] > 1e3]  # the outer spans, sorted by start
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        j = bisect.bisect_right(starts, mid)
        near = [h for h in host[max(0, j - 256):j] if h[1] >= mid]
        near = near or [h for h in long if h[0] <= mid <= h[1]]
        out.append((near[-1][2] if near else "host: no event", (b - a) / 1e6))
    return sorted(out, key=lambda kv: -kv[1])


class DeviceTrace:
    """with DeviceTrace(host) as tr: ... ; then tr.reduce() -> TraceSummary.
    The stretch is timed between two synchronizes; the reduction runs after
    it, outside whatever the caller times. `host=False` records device
    activity alone, which costs the host least (busy time, kernels); with
    `host=True` the CPU's operators and spans are recorded too, to name the
    idle gaps, at a cost to the host that widens them."""

    def __init__(self, host: bool) -> None:
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.host else [ProfilerActivity.CUDA]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> TraceSummary:
        return reduce_events(self._prof.events(), self.window_s)


def reduce_events(events, window_s: float) -> TraceSummary:
    dev, host, by_name = [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's shadow on the device timeline, or a runtime marker: not device work
            if e.is_user_annotation or e.name.startswith("Command Buffer"):
                continue
            dev.append((a, b))
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (b - a) / 1e6)
        else:
            host.append((a, b, e.name))
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    busy = union(dev)
    host.sort()
    gaps = []
    if host:
        gaps = name_gaps(busy, host, min(host[0][0], busy[0][0]), max(max(h[1] for h in host), busy[-1][1]))
    return TraceSummary(window_s=window_s, busy_s=sum(b - a for a, b in busy) / 1e6, by_name=by_name, gaps=gaps)
