"""Generative serving on the port: paged KV pool + continuous batching.

    from distkeras_tpu_torch.serving import GenerationEngine

    gen = GenerationEngine(model, page_size=16, num_slots=8,
                           prefill_buckets=(32, 128))
    fut = gen.generate(prompt, max_new_tokens=64, stream=print)
    result = fut.result()          # GenerationResult(tokens, reason)
    gen.shutdown()
"""

from distkeras_tpu_torch.serving.batching import (
    DeadlineExceeded,
    EngineClosed,
    QueueFull,
    Request,
    RequestQueue,
)
from distkeras_tpu_torch.serving.buckets import DEFAULT_BUCKETS, BucketSpec
from distkeras_tpu_torch.serving.generation import (
    GenerationEngine,
    GenerationResult,
)
from distkeras_tpu_torch.serving.kv_cache import PagedKVCachePool

__all__ = [
    "BucketSpec",
    "DEFAULT_BUCKETS",
    "DeadlineExceeded",
    "EngineClosed",
    "GenerationEngine",
    "GenerationResult",
    "PagedKVCachePool",
    "QueueFull",
    "Request",
    "RequestQueue",
]
