"""Dynamic micro-batching: a bounded request queue + coalescing batcher.

The reference's online story was the Kafka notebook — score records as
they arrive, one micro-batch at a time (SURVEY §2 "Examples"). This module
is the load-bearing half of that story done properly: individual requests
arrive on arbitrary threads, enter one bounded FIFO (backpressure: a full
queue REJECTS instead of buffering unboundedly — a latency SLO dies the
moment an unbounded queue starts growing), and a single batcher thread
coalesces them into micro-batches of at most ``max_batch_size`` rows,
waiting at most ``max_wait_s`` past the first request's arrival —
whichever limit binds first.

Deadline semantics: a request may carry an absolute deadline; it is
checked when the batcher POPS the request (execution start). An expired
request completes its future with :class:`DeadlineExceeded` — never a
silent drop — and does not occupy a row in the forward pass. Requests
that expire while executing still complete normally (the result is
already paid for).

Telemetry (all under ``serving.*``, see DESIGN.md §7): ``queue_depth``
gauge, ``batch_size``/``batch_wait_s`` histograms, ``submitted``/
``rejected``/``deadline_exceeded`` counters.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

from distkeras_tpu_torch import telemetry


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before execution started."""


class QueueFull(RuntimeError):
    """Backpressure: the bounded request queue is at capacity."""


class EngineClosed(RuntimeError):
    """submit() after shutdown(), or pending work cancelled by a
    non-draining shutdown."""


class Request:
    """One row in flight: payload + the future its caller is waiting on.

    ``t_submit``/``deadline`` are ``time.monotonic`` seconds; ``deadline``
    is None for no-timeout requests. ``trace``/``t_perf`` carry the
    submitter's trace context and the submit instant on the span time
    base (perf_counter) so the batcher thread can record queue-wait and
    compute spans under the request's trace_id (DESIGN.md §15).
    """

    __slots__ = ("x", "future", "t_submit", "deadline", "trace", "t_perf")

    def __init__(self, x, t_submit: float, deadline: Optional[float],
                 trace=None):
        self.x = x
        self.future: Future = Future()
        self.t_submit = t_submit
        self.deadline = deadline
        self.trace = trace
        self.t_perf = time.perf_counter()

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class RequestQueue:
    """Bounded FIFO between submitters and the batcher thread.

    ``put``/``put_many`` are all-or-nothing: they raise :class:`QueueFull`
    without enqueueing anything when capacity would be exceeded (the
    caller sheds load instead of the queue absorbing it), and
    :class:`EngineClosed` after ``close()``.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._dq: "collections.deque[Request]" = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._depth = telemetry.gauge("serving.queue_depth")
        self._rejected = telemetry.counter("serving.rejected")
        self._expired = telemetry.counter("serving.deadline_exceeded")
        self._batch_size = telemetry.histogram("serving.batch_size")
        self._batch_wait = telemetry.histogram("serving.batch_wait_s")

    def __len__(self) -> int:
        return len(self._dq)

    def oldest_age(self, now: Optional[float] = None) -> Optional[float]:
        """Age (seconds) of the oldest queued request, or None when empty —
        the health plane's head-of-line latency signal."""
        with self._cv:
            if not self._dq:
                return None
            return (time.monotonic() if now is None else now) \
                - self._dq[0].t_submit

    def put(self, req: Request) -> None:
        self.put_many((req,))

    def put_many(self, reqs: Sequence[Request]) -> None:
        with self._cv:
            if self._closed:
                raise EngineClosed("engine is shut down; no new requests")
            if len(self._dq) + len(reqs) > self.capacity:
                self._rejected.inc(len(reqs))
                raise QueueFull(
                    f"request queue at {len(self._dq)}/{self.capacity}; "
                    f"cannot admit {len(reqs)} more rows")
            self._dq.extend(reqs)
            self._depth.set(len(self._dq))
            self._cv.notify()

    def next_batch(self, max_batch: int,
                   max_wait_s: float) -> Optional[List[Request]]:
        """Block until at least one request is queued, coalesce up to
        ``max_batch`` rows or until ``max_wait_s`` past the FIRST queued
        request's submit time, then pop. Expired requests are completed
        with DeadlineExceeded and excluded (so the returned list may be
        empty). Returns None once closed AND drained — the batcher's exit
        signal.
        """
        with self._cv:
            while not self._dq:
                if self._closed:
                    return None
                self._cv.wait()
            first_t = self._dq[0].t_submit
            flush_at = first_t + max_wait_s
            while len(self._dq) < max_batch and not self._closed:
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            now = time.monotonic()
            batch: List[Request] = []
            expired: List[Request] = []
            while self._dq and len(batch) < max_batch:
                req = self._dq.popleft()
                (expired if req.expired(now) else batch).append(req)
            self._depth.set(len(self._dq))
        # complete futures outside the lock: a done-callback may submit
        for req in expired:
            req.future.set_exception(DeadlineExceeded(
                f"deadline passed {1e3 * (now - req.deadline):.1f} ms "
                f"before execution started"))
        if expired:
            self._expired.inc(len(expired))
        if batch:
            self._batch_size.record(len(batch))
            self._batch_wait.record(now - first_t)
        return batch

    def close(self) -> None:
        """Stop admitting requests; wakes a blocked ``next_batch``. Queued
        requests stay poppable (the draining shutdown path)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def fail_pending(self, exc: Exception) -> int:
        """Non-draining shutdown: pop everything and fail the futures.
        Returns how many were cancelled."""
        with self._cv:
            pending = list(self._dq)
            self._dq.clear()
            self._depth.set(0)
        for req in pending:
            req.future.set_exception(exc)
        return len(pending)
