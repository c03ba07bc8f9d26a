"""Bounded reconnect/retry policy for the PS transport.

The fault-tolerant wire (DESIGN.md §13) retries a failed round-trip on a
fresh connection a bounded number of times, sleeping an exponentially
growing, jittered delay between attempts. The jitter is seeded (one RNG
per policy instance) so a scripted chaos test sees the same delay
sequence every run — retry behavior must be assertable, not timing luck.

Like the rest of ``comms/``, this module never imports jax.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for transport retries.

    ``delay(attempt)`` for attempt 1, 2, ... is
    ``min(base_s * 2**(attempt-1), max_s)`` scaled by a uniform jitter in
    ``[1 - jitter, 1 + jitter]`` — full exponential backoff with
    decorrelation so N workers retrying a dead shard do not reconnect in
    lockstep.
    """

    max_retries: int = 4
    base_s: float = 0.05
    max_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_s <= 0 or self.max_s < self.base_s:
            raise ValueError(
                f"need 0 < base_s <= max_s, got {self.base_s}/{self.max_s}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        # dataclass(frozen=True): route mutable state around the freeze
        object.__setattr__(self, "_rng", random.Random(self.seed))
        object.__setattr__(self, "_lock", threading.Lock())

    def delay(self, attempt: int) -> float:
        """Sleep time before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        raw = min(self.base_s * (2.0 ** (attempt - 1)), self.max_s)
        with self._lock:  # Random() is not thread-safe across workers
            scale = 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return raw * scale


#: Policy used when a caller passes none: a few quick retries, bounded
#: well under the history-barrier timeout so exhaustion surfaces as a
#: typed PSUnavailable instead of a silent stall.
DEFAULT_RETRY = RetryPolicy()
