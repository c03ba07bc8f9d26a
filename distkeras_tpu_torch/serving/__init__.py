"""Serving on the port: one-shot micro-batched inference
(``ServingEngine``), generative serving on a rectangular or paged KV pool
with continuous batching (``GenerationEngine``), one CUDA graph per
declared shape (in each weight bank) on the card, live weight
rollout (``RolloutController``) and the socket front end
(``ServingServer``/``ServingClient``, the JAX package's wire).

    from distkeras_tpu_torch.serving import GenerationEngine

    gen = GenerationEngine(model, num_slots=8, prefill_buckets=(32, 128))
    # paged: page_size=16 (optionally prefill_chunk=32,
    # prefix_cache_bytes=1 << 30, kv_dtype="int8"); sampled:
    # sampling=True, temperature=0.7, seed=321; speculative:
    # draft=NgramDraft(), spec_k=4 (or draft=ModelDraft(small_model))
    fut = gen.generate(prompt, max_new_tokens=64, stream=print)
    result = fut.result()          # GenerationResult(tokens, reason)

    eng = ServingEngine(CausalLM(attention="flash", ...), (128,),
                        input_dtype=np.int32, buckets=(1, 4))
    ctl = RolloutController(engine=eng, generator=gen)
    srv = ServingServer(eng, host="127.0.0.1", token=secret,
                        generator=gen, rollout=ctl)
    srv.start()
    client = ServingClient(f"127.0.0.1:{srv.port}", token=secret)
    client.generate(prompt, max_new_tokens=64)
    client.put_weights(new_state_dict, version=1, target="both")
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
from distkeras_tpu_torch.serving.engine import ServingEngine
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
from distkeras_tpu_torch.serving.rollout import (CanaryConfig,
                                                 RolloutController,
                                                 WeightPublisher)
from distkeras_tpu_torch.serving.server import ServingClient, ServingServer

__all__ = [
    "BucketSpec",
    "CanaryConfig",
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
    "RolloutController",
    "ServingClient",
    "ServingEngine",
    "ServingServer",
    "WeightPublisher",
    "make_decode_fn",
    "make_prefill_fn",
    "make_swap_in_fn",
    "make_swap_out_fn",
    "make_verify_fn",
]
