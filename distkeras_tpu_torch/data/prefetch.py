"""Background prefetch (port of ``distkeras_tpu/data/prefetch.py``): a
reader thread ahead of the device.

The staging generator (``substrate.stage_epoch_chunks``, which the
single trainer's step chunks go through too) does host-side work per
chunk — disk reads for file-backed datasets, the O(chunk) stack/copy
into pinned memory, and the (asynchronous) copy to the card on a side
stream. Running the generator on a daemon thread with a small bounded
queue overlaps ALL of that with device compute on the previous chunk;
the consumer just drains the queue. This is the stand-in for the
reference's Spark executors prefetching partition iterators.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Iterable, Iterator, TypeVar

from distkeras_tpu_torch import telemetry

T = TypeVar("T")

_DONE = object()


def prefetch(it: Iterable[T], depth: int = 1) -> Iterator[T]:
    """Iterate ``it`` on a background thread, keeping up to ``depth`` items
    queued. Exceptions raised by the producer re-raise at the consumer's
    ``next()`` with the producer-side frames preserved as text on
    ``exc.producer_traceback`` (and a ``data.prefetch.producer_errors``
    count); ordering is preserved.

    Memory bound: at most ``depth + 1`` items exist beyond the one the
    consumer holds (``depth`` queued plus one the blocked producer has
    already built) — with the default ``depth=1`` that is classic double
    buffering. If the consumer abandons the generator (break / exception),
    its ``finally`` signals the producer, which drops its pending item and
    exits instead of blocking forever holding device buffers.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    abandoned = threading.Event()
    # queue occupancy seen by the consumer: persistently 0 = producer-bound
    # (disk/staging is the bottleneck), persistently `depth` = device-bound
    depth_gauge = telemetry.gauge("data.prefetch.queue_depth")
    depth_hist = telemetry.histogram("data.prefetch.queue_depth_samples")
    wait_hist = telemetry.histogram("data.prefetch.producer_wait_s")
    puts = telemetry.counter("data.prefetch.puts")
    # one poll interval of the give-up loop below: an uncontended put
    # completes well inside this, so only waits beyond it are real
    # backpressure (recording every put drowned the histogram in ~0 s
    # fast-path samples and dragged the reported mean toward zero)
    _POLL_S = 0.1

    def _put(item) -> bool:
        """put that gives up when the consumer is gone."""
        t0 = time.perf_counter()
        while not abandoned.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                puts.inc()
                # time the producer sat blocked on a full queue — the
                # backpressure the bounded buffer applies. Uncontended
                # fast-path puts (shorter than one poll interval) are
                # counted by `puts` but kept out of the histogram.
                waited = time.perf_counter() - t0
                if waited > _POLL_S:
                    wait_hist.record(waited)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not _put((False, item)):
                    return
        except BaseException as e:  # propagate, don't swallow
            # the exception re-raises on the CONSUMER thread, where its
            # __traceback__ stops at this thread's boundary — carry the
            # producer-side frames (the disk read / staging code that
            # actually blew up) along as text
            telemetry.counter("data.prefetch.producer_errors").inc()
            _put((True, (e, traceback.format_exc())))
            return
        _put((False, _DONE))

    thread = threading.Thread(target=run, daemon=True,
                              name="distkeras-prefetch")
    thread.start()
    try:
        while True:
            size = q.qsize()
            depth_gauge.set(size)
            depth_hist.record(size)
            is_err, item = q.get()
            if is_err:
                exc, tb_text = item
                # attach the producer-side frames for handlers/logs; the
                # chained note keeps `raise` semantics (type and args)
                # identical to re-raising the original
                exc.producer_traceback = tb_text
                raise exc
            if item is _DONE:
                return
            yield item
    finally:
        abandoned.set()
