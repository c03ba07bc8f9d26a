"""Wire codecs and chunked transport for the parameter-server path (port
of ``distkeras_tpu/comms``): pluggable leaf codecs (raw, f16/bf16 casts,
int8 affine quantization with worker-side error feedback), chunked
zero-copy egress and the seeded retry policy."""

from distkeras_tpu_torch.comms.chunking import (
    DEFAULT_CHUNK_BYTES,
    iter_chunks,
    leaf_buffer,
    send_buffers,
)
from distkeras_tpu_torch.comms.codec import (
    Bf16Codec,
    Codec,
    EncodedParameterServer,
    ErrorFeedback,
    Fp16Codec,
    QuantCodec,
    RawCodec,
    available_codecs,
    get_codec,
    negotiate,
)
from distkeras_tpu_torch.comms.retry import DEFAULT_RETRY, RetryPolicy

__all__ = [
    "Codec", "RawCodec", "Fp16Codec", "Bf16Codec", "QuantCodec",
    "ErrorFeedback", "EncodedParameterServer",
    "get_codec", "available_codecs", "negotiate",
    "leaf_buffer", "iter_chunks", "send_buffers", "DEFAULT_CHUNK_BYTES",
    "RetryPolicy", "DEFAULT_RETRY",
]
