"""Generative serving on the port: rectangular or paged KV pool +
continuous batching, one CUDA graph per declared shape on the card.

    from distkeras_tpu_torch.serving import GenerationEngine

    gen = GenerationEngine(model, num_slots=8, prefill_buckets=(32, 128))
    # paged: page_size=16 (optionally prefill_chunk=32,
    # prefix_cache_bytes=1 << 30, kv_dtype="int8"); sampled:
    # sampling=True, temperature=0.7, seed=321; speculative:
    # draft=NgramDraft(), spec_k=4 (or draft=ModelDraft(small_model))
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
    ModelDraft,
    NgramDraft,
    make_decode_fn,
    make_prefill_fn,
    make_swap_in_fn,
    make_swap_out_fn,
    make_verify_fn,
)
from distkeras_tpu_torch.serving.kv_cache import (KVCachePool,
                                                  PagedKVCachePool,
                                                  PrefixCache)

__all__ = [
    "BucketSpec",
    "DEFAULT_BUCKETS",
    "DeadlineExceeded",
    "EngineClosed",
    "GenerationEngine",
    "GenerationResult",
    "KVCachePool",
    "ModelDraft",
    "NgramDraft",
    "PagedKVCachePool",
    "PrefixCache",
    "QueueFull",
    "Request",
    "RequestQueue",
    "make_decode_fn",
    "make_prefill_fn",
    "make_swap_in_fn",
    "make_swap_out_fn",
    "make_verify_fn",
]
