"""Wire codecs and the affine quantization rule (port of part of
``distkeras_tpu/comms/codec.py``).

A :class:`Codec` turns one leaf (a numpy array whose shape and dtype
both ends agreed on out of band) into a wire blob and back. Only the
raw codec is ported (native bytes, exact, zero-copy on encode): the
serving wire's ``weights_put`` and ``kv_export``/``kv_handoff`` use it.
The lossy codecs (f16, bf16, int8 with error feedback) and their
handshake are ROADMAP.md Queue A, item 13; :func:`get_codec` raises
for them.

One scale rule serves the parameter-server wire codec (``lo=min``,
``hi=max``, ``levels=255``), the in-step int8 quantizer of
:mod:`distkeras_tpu_torch.precision` and the int8 KV pages of
:mod:`distkeras_tpu_torch.models.gpt` (``lo=-amax``, ``hi=+amax``,
``levels=254``).
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.comms.chunking import leaf_buffer

#: the JAX package's codec names; all but "raw" are item 13
_UNPORTED = ("bf16", "f16", "int8")


def _from_bytes(blob, dtype, shape) -> np.ndarray:
    arr = np.frombuffer(blob, dtype=dtype)
    if arr.size != int(np.prod(shape)):
        raise ValueError(
            f"blob of {arr.size} elements does not match leaf shape {shape}")
    return arr.reshape(shape)


class Codec:
    """Leaf codec protocol: stateless, one instance serves every
    connection and thread."""

    name = "abstract"
    #: True when decode(encode(x)) != x in general
    lossy = False

    def encode(self, arr: np.ndarray, kind: str = "commit"):
        """Array -> bytes-like wire blob."""
        raise NotImplementedError

    def decode(self, blob, shape, dtype, kind: str = "commit") -> np.ndarray:
        """Wire blob -> array of exactly (shape, dtype)."""
        raise NotImplementedError


class RawCodec(Codec):
    """Native bytes on the wire: exact, and zero-copy on encode."""

    name = "raw"

    def encode(self, arr, kind: str = "commit"):
        return leaf_buffer(arr)

    def decode(self, blob, shape, dtype, kind: str = "commit"):
        return _from_bytes(blob, dtype, shape)


_RAW = RawCodec()


def get_codec(codec) -> Codec:
    """Resolve a codec by name (or pass a Codec instance through). Only
    ``"raw"`` is ported; the JAX package's lossy codecs raise
    NotImplementedError, any other name ValueError as in JAX."""
    if isinstance(codec, Codec):
        return codec
    if str(codec) == "raw":
        return _RAW
    if str(codec) in _UNPORTED:
        raise NotImplementedError(
            f"codec {codec!r} is not ported yet (ROADMAP.md Queue A, item "
            f"13: the lossy wire codecs); only 'raw' is available")
    raise ValueError(f"Unknown codec {codec!r}; available: ('raw',)")


def affine_qparams(lo, hi, levels: int):
    """Quantization step of an affine grid of ``levels + 1`` codes
    spanning ``[lo, hi]``."""
    return (hi - lo) / levels


def affine_quantize(a: torch.Tensor, lo, scale: torch.Tensor,
                    levels: int) -> torch.Tensor:
    """Codes in ``[0, levels]`` (float) for the grid ``lo + scale * q``.
    Division, not a multiply by the reciprocal, and round half to even,
    as the wire arithmetic does; a zero scale (a constant leaf) maps every
    element to code 0."""
    ok = scale > 0
    safe = torch.where(ok, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((a - lo) / safe), 0, levels)
    return torch.where(ok, q, torch.zeros_like(q))


def affine_dequantize(q: torch.Tensor, lo, scale) -> torch.Tensor:
    """Inverse of :func:`affine_quantize`: ``lo + scale * q``."""
    return lo + scale * q
