"""Dynamic request batching for `predict_action` serving.

At small batch the 7B decode is weight-streaming-bound, so N coalesced
requests cost about one request's wall-clock. Concurrent callers submit
(frame, instruction) requests; a worker thread coalesces them into
mixed-task batches (VLAPolicy.get_action_multi) under a latency bound.

Batches are padded up to a fixed bucket ladder (powers of two by default),
so the device sees O(log max_batch) batch shapes; `warmup()` runs every
bucket once before traffic. Padding rows replicate row 0 and their outputs
are dropped.

In drafts mode (`drafts=True`) every batch runs the policy's Jacobi tail:
clients send the tokens of their previous reply as the next request's draft
(`submit_full`), and rows without one get a zero draft.

Threading model: one worker thread owns the policy and the device; callers
block on `concurrent.futures.Future`s.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

_SENTINEL = object()


class ActResult(NamedTuple):
    """What submit_full() resolves to: the action and the greedy tokens that
    produced it, which the client sends back as `draft_tokens` with its
    next request."""

    action: np.ndarray  # [7] unnormalized
    tokens: Optional[np.ndarray]  # [7] int32 (None if the policy has no tokens)


def _fail_future(fut: Future, exc: BaseException) -> None:
    """set_exception that tolerates a caller having cancelled the future —
    an InvalidStateError here must never kill the worker/closer."""
    try:
        fut.set_exception(exc)
    except Exception:
        pass


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to and including max_batch (max_batch is always the
    last bucket even when it is not a power of two)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class DynamicBatcher:
    """Coalesces concurrent get_action requests into bucketed batches.

    policy        : VLAPolicy (or anything with `get_action_multi(images,
                    tasks) -> [N, 7]`).
    max_batch     : largest batch to run at once.
    max_wait_ms   : how long the worker holds the FIRST request of a batch
                    while more arrive. The latency bound for a lone request
                    is ~max_wait_ms + one decode.
    buckets       : ascending batch shapes; default powers of two.
    drafts        : run every batch through the policy's Jacobi tail
                    (get_action_multi draft_tokens=...), with the drafts
                    given to submit_full and zeros for requests without one.
                    A constructor mode, so warmup() runs the path the worker
                    will run. The policy then needs `vocab_size`: a draft id
                    outside [0, vocab_size) is refused at submit time.

    Shutdown: `close()` stops new submissions, fails every request still in
    the queue with RuntimeError (the in-flight batch, if any, completes), and
    joins the worker. Use as a context manager.
    """

    def __init__(
        self,
        policy,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        drafts: bool = False,
    ) -> None:
        self.policy = policy
        self.drafts = bool(drafts)
        self.vocab_size = int(policy.vocab_size) if self.drafts else None
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.buckets = tuple(sorted(buckets)) if buckets else default_buckets(
            self.max_batch
        )
        if self.buckets[-1] != self.max_batch:
            raise ValueError(
                f"buckets {self.buckets} must end at max_batch={self.max_batch}"
            )
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "requests": 0, "batches": 0, "padded_rows": 0, "errors": 0,
        }
        self._bucket_counts: Dict[int, int] = {b: 0 for b in self.buckets}
        # submit->resolve wall-clock of the last 1024 served requests
        self._latencies: List[float] = []
        # Jacobi verification passes of the last 1024 drafted batches
        self._verify_passes: List[int] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, name="vla-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, image_u8: np.ndarray, task_label: str) -> Future:
        """Enqueue one request; returns a Future resolving to the [7] action."""
        return self._submit(image_u8, task_label, None, False)

    def submit_full(self, image_u8: np.ndarray, task_label: str, draft_tokens=None) -> Future:
        """Like submit(), but the Future resolves to an ActResult (action and
        tokens), and `draft_tokens` [7] from the client's previous reply
        seeds the Jacobi tail (check_draft says what it must be)."""
        if draft_tokens is not None:
            draft_tokens = self.check_draft(draft_tokens)
        return self._submit(image_u8, task_label, draft_tokens, True)

    def check_draft(self, draft_tokens) -> np.ndarray:
        """A client's draft as [7] int32 ids. ValueError unless the batcher
        runs drafts and the draft is 7 integers in [0, vocab_size): a bad id
        would fail the whole batch it lands in, on the card by poisoning the
        CUDA context."""
        if not self.drafts:
            raise ValueError(
                "draft_tokens needs DynamicBatcher(drafts=True): its warmup runs "
                "the Jacobi path, a plain batcher's does not"
            )
        d = np.asarray(draft_tokens)
        if d.shape != (7,) or d.dtype.kind not in "iu":
            raise ValueError(f"draft_tokens must be 7 integer token ids, got {d.dtype} of shape {d.shape}")
        if d.min() < 0 or d.max() >= self.vocab_size:
            raise ValueError(f"draft_tokens hold ids outside [0, {self.vocab_size}): {d.tolist()}")
        return d.astype(np.int32)

    def _submit(self, image_u8, task_label, draft, wants_full) -> Future:
        fut: Future = Future()
        # the closed-check and the put are atomic vs close(): once close()
        # flips _closed under this lock, no request can slip in after its
        # queue drain and hang its caller forever
        with self._lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put((np.asarray(image_u8), str(task_label), fut, time.monotonic(),
                         draft, wants_full))
            self.stats["requests"] += 1
        return fut

    def get_action(
        self, image_u8: np.ndarray, task_label: str,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        """Blocking convenience wrapper: submit + wait."""
        return self.submit(image_u8, task_label).result(timeout=timeout)

    def warmup(self, image_u8: np.ndarray, task_label: str = "warmup") -> None:
        """Run every bucket's batch shape once before traffic (in drafts
        mode through the Jacobi tail, the path the worker runs)."""
        for b in self.buckets:
            imgs = np.stack([image_u8] * b)
            if self.drafts:
                self.policy.get_action_multi(imgs, [task_label] * b,
                                             draft_tokens=np.zeros((b, 7), np.int32))
            else:
                self.policy.get_action_multi(imgs, [task_label] * b)

    def bucket_counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._bucket_counts)

    def latency_quantiles(self) -> Dict[str, float]:
        """Submit->resolve wall-clock quantiles over the last 1024 served
        requests (seconds). Empty dict before any request resolves."""
        with self._lock:
            lat = list(self._latencies)
        if not lat:
            return {}
        lat.sort()

        def q(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 4)

        return {"p50_s": q(0.50), "p95_s": q(0.95), "p99_s": q(0.99),
                "n": len(lat)}

    def verify_pass_stats(self) -> Dict[str, float]:
        """Mean/max/sum of the Jacobi verification passes over the last 1024
        drafted batches (empty before any; a mean of 1.0 = every draft
        accepted whole)."""
        with self._lock:
            vp = list(self._verify_passes)
        if not vp:
            return {}
        return {"mean": round(sum(vp) / len(vp), 2), "max": max(vp), "sum": sum(vp), "n": len(vp)}

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests, fail everything still queued, stop the
        worker. Any batch already executing completes and resolves its
        futures; `timeout` bounds the join on it (None = wait)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # Fail queued-but-unstarted requests BEFORE posting the sentinel (so
        # this drain can never swallow it). Queue semantics hand each request
        # to exactly one side — served or failed, never both, never neither.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            _fail_future(item[2], RuntimeError("batcher closed"))
        self._q.put(_SENTINEL)
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- worker
    def _take_batch(self) -> Optional[List]:
        """Block for the first request, then soak more until max_batch or the
        deadline. Returns None on shutdown."""
        first = self._q.get()
        if first is _SENTINEL:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _SENTINEL:
                self._q.put(_SENTINEL)  # re-post for the outer loop to see
                break
            batch.append(item)
        return batch

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            # claim each future; a caller who cancel()ed while queued is
            # dropped here — and can no longer cancel, so set_result /
            # set_exception below cannot raise InvalidStateError and kill
            # this thread
            batch = [b for b in batch if b[2].set_running_or_notify_cancel()]
            if not batch:
                continue
            images = [b[0] for b in batch]
            tasks = [b[1] for b in batch]
            futures = [b[2] for b in batch]
            submit_ts = [b[3] for b in batch]
            drafts = [b[4] for b in batch]
            wants_full = [b[5] for b in batch]
            n = len(batch)
            bucket = self._bucket_for(n)
            # pad to the bucket shape with row-0 replicas (outputs dropped)
            for _ in range(bucket - n):
                images.append(images[0])
                tasks.append(tasks[0])
                drafts.append(drafts[0])
            try:
                if self.drafts:
                    # zeros for rows without a draft: bounded by the
                    # sequential tail
                    d = np.stack([np.zeros(7, np.int32) if x is None else x for x in drafts])
                    actions = self.policy.get_action_multi(np.stack(images), tasks, draft_tokens=d)
                else:
                    actions = self.policy.get_action_multi(np.stack(images), tasks)
            except Exception as e:  # fail THIS batch; keep serving
                with self._lock:
                    self.stats["errors"] += 1
                for f in futures:
                    _fail_future(f, e)
                continue
            tokens = getattr(self.policy, "last_tokens", None)
            passes = getattr(self.policy, "last_verify_passes", None)
            now = time.monotonic()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["padded_rows"] += bucket - n
                self._bucket_counts[bucket] += 1
                self._latencies.extend(now - t for t in submit_ts)
                del self._latencies[:-1024]
                if passes is not None:
                    self._verify_passes.append(int(passes))
                    del self._verify_passes[:-1024]
            for i, (f, a) in enumerate(zip(futures, actions[:n])):
                a = np.asarray(a)
                if wants_full[i]:
                    a = ActResult(action=a, tokens=None if tokens is None else np.asarray(tokens[i]))
                try:
                    f.set_result(a)
                except Exception:  # never kill the worker
                    pass
