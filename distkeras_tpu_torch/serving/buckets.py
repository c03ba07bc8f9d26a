"""Shape bucketing — the contract that keeps the serving jit cache bounded.

Dynamic micro-batching produces batches of *every* size between 1 and
``max_batch_size``; compiling one XLA executable per observed size would
mean O(max_batch_size) compilations, each a multi-second stall taken on
the request path. The fix is the standard serving trick (TF-Serving's
``allowed_batch_sizes``, TGI/vLLM bucket padding): declare a small sorted
set of bucket sizes up front, pad every micro-batch up to the smallest
bucket that fits, and pre-compile exactly one executable per bucket at
warmup. After warmup the compile cache can never grow — the engine asserts
this invariant (`tests/test_serving.py`).

Padding rows are zeros and their outputs are discarded before scatter;
row results are unaffected because the forward pass is row-independent
(proven bitwise against the unbatched jit forward in tests).
"""

from __future__ import annotations

import bisect
from typing import Sequence, Tuple

#: Default bucket ladder: powers of four-ish keep the worst-case padding
#: waste under 4x while needing only 4 compiled executables.
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128)


class BucketSpec:
    """A sorted, validated set of micro-batch sizes to pad up to.

    ``bucket_for(n)`` returns the smallest declared bucket >= n; asking for
    more rows than the largest bucket is a caller bug (the batcher caps
    micro-batches at ``max_batch_size <= max(sizes)``) and raises.
    """

    def __init__(self, sizes: Sequence[int] = DEFAULT_BUCKETS):
        sizes = tuple(int(s) for s in sizes)
        if not sizes:
            raise ValueError("at least one bucket size is required")
        if any(s < 1 for s in sizes):
            raise ValueError(f"bucket sizes must be >= 1, got {sizes}")
        if len(set(sizes)) != len(sizes):
            raise ValueError(f"duplicate bucket sizes in {sizes}")
        self.sizes: Tuple[int, ...] = tuple(sorted(sizes))

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"batch must hold >= 1 row, got {n}")
        i = bisect.bisect_left(self.sizes, n)
        if i == len(self.sizes):
            raise ValueError(
                f"{n} rows exceed the largest declared bucket "
                f"{self.max_size}; batches must be capped at max_batch_size")
        return self.sizes[i]

    def padding_rows(self, n: int) -> int:
        """Rows of zero-padding a batch of ``n`` pays — the waste the
        padding histogram records."""
        return self.bucket_for(n) - n

    def __repr__(self) -> str:
        return f"BucketSpec({self.sizes})"

    def __iter__(self):
        return iter(self.sizes)

    def __len__(self) -> int:
        return len(self.sizes)
