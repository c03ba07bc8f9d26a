"""Wire codecs for the parameter-server path and the affine quantization
rule (port of ``distkeras_tpu/comms/codec.py``).

A :class:`Codec` turns one leaf (a numpy array whose shape and dtype both
ends agreed on out of band) into a wire blob and back. Blobs carry their
own per-leaf metadata inline (the int8 codec's scale and offset as a
fixed-size prefix), so a message stays "a list of blobs" under every
codec. The bytes are the JAX package's, byte for byte, so a client of
either package talks to a service of the other:

- :class:`RawCodec` — native bytes, exact, zero-copy on encode;
- :class:`Fp16Codec` / :class:`Bf16Codec` — float leaves cast on the
  wire (2x smaller), cast back to the leaf's dtype on decode. bf16 is
  round-to-nearest-even with NaN kept quiet and signed, as ``ml_dtypes``
  converts; the port computes it from the float32 bits and needs no
  ``ml_dtypes``;
- :class:`QuantCodec` (``"int8"``) — per-leaf affine quantization of
  commits (about 4x on float32), ``[f32 scale][f32 lo][uint8 codes]``;
  pulls go as f16 casts (an absolute center has no error feedback to
  absorb quantization). Lossy commits run through :class:`ErrorFeedback`.

``kind="commit"`` encodes deltas (worker -> server), ``kind="pull"`` the
center (server -> worker). Integer and bool leaves pass through raw under
every codec.

The one affine scale rule serves the wire codec (``lo=min``, ``hi=max``,
``levels=255``), the in-step int8 quantizer of
:mod:`distkeras_tpu_torch.precision` and the int8 KV pages of
:mod:`distkeras_tpu_torch.models.gpt` (``lo=-amax``, ``hi=+amax``,
``levels=254``).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms.chunking import leaf_buffer
from distkeras_tpu_torch.utils.transfer import to_host
from distkeras_tpu_torch.utils.trees import tree_flatten, tree_unflatten

Spec = Tuple[tuple, np.dtype]  # (shape, dtype) agreed out of band


def _is_float(dtype) -> bool:
    # numpy floats, and extension floats (bfloat16, float8) that register
    # as void-kind dtypes with a float name
    dt = np.dtype(dtype)
    return np.issubdtype(dt, np.floating) or dt.name.startswith(
        ("bfloat", "float8", "float4", "float6"))


def _from_bytes(blob, dtype, shape) -> np.ndarray:
    arr = np.frombuffer(blob, dtype=dtype)
    if arr.size != int(np.prod(shape)):
        raise ValueError(
            f"blob of {arr.size} elements does not match leaf shape {shape}")
    return arr.reshape(shape)


class Codec:
    """Leaf codec protocol: stateless, one instance serves every
    connection and thread (error feedback, the stateful half, lives in
    :class:`ErrorFeedback`)."""

    name = "abstract"
    #: True when decode(encode(x)) != x in general; lossy commit paths
    #: must run through ErrorFeedback
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


def f32_to_bf16_bits(arr) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16): round to nearest even,
    NaN to the signed quiet NaN ``sign | 0x7fc0``, as ``ml_dtypes``
    casts."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    bits = a.view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = ((bits >> 16) & np.uint32(0x8000)).astype(np.uint16) \
        | np.uint16(0x7FC0)
    return np.where(np.isnan(a), nan, rounded)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32)
            << 16).view(np.float32)


class _CastCodec(Codec):
    """Float leaves cross the wire in a narrower float dtype."""

    lossy = True

    def _narrow(self, arr: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _widen(self, wire: np.ndarray, dtype) -> np.ndarray:
        raise NotImplementedError

    def encode(self, arr, kind: str = "commit"):
        if not _is_float(arr.dtype):
            return leaf_buffer(arr)
        return leaf_buffer(self._narrow(np.asarray(arr)))

    def decode(self, blob, shape, dtype, kind: str = "commit"):
        if not _is_float(dtype):
            return _from_bytes(blob, dtype, shape)
        wire = _from_bytes(blob, np.uint16, shape)
        return self._widen(wire, dtype)


class Fp16Codec(_CastCodec):
    name = "f16"

    def _narrow(self, arr):
        return np.asarray(arr, dtype=np.float16)

    def _widen(self, wire, dtype):
        return np.asarray(wire.view(np.float16), dtype=dtype)


class Bf16Codec(_CastCodec):
    name = "bf16"

    def _narrow(self, arr):
        if np.dtype(arr.dtype).name == "bfloat16":
            return arr.view(np.uint16)
        return f32_to_bf16_bits(arr)

    def _widen(self, wire, dtype):
        if np.dtype(dtype).name == "bfloat16":
            return wire.view(dtype)
        return np.asarray(bf16_bits_to_f32(wire), dtype=dtype)


def affine_qparams(lo, hi, levels: int):
    """Quantization step of an affine grid of ``levels + 1`` codes
    spanning ``[lo, hi]``."""
    return (hi - lo) / levels


def affine_quantize(a, lo, scale, levels: int):
    """Codes in ``[0, levels]`` (float) for the grid ``lo + scale * q``,
    on tensors or numpy arrays. Division, not a multiply by the
    reciprocal, and round half to even, as the wire arithmetic does; a
    zero scale (a constant leaf) maps every element to code 0."""
    if isinstance(a, torch.Tensor):
        ok = scale > 0
        safe = torch.where(ok, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round((a - lo) / safe), 0, levels)
        return torch.where(ok, q, torch.zeros_like(q))
    ok = scale > 0
    safe = np.where(ok, scale, np.ones_like(scale * 1.0))
    q = np.clip(np.rint((a - lo) / safe), 0, levels)
    return np.where(ok, q, np.zeros_like(q))


def affine_dequantize(q, lo, scale):
    """Inverse of :func:`affine_quantize`: ``lo + scale * q``."""
    return lo + scale * q


class QuantCodec(Codec):
    """Per-leaf int8 affine quantization for commits; f16 casts for
    pulls. Commit blob: ``[f32 scale][f32 lo][uint8 codes]``; decode is
    ``lo + scale * q``. The scale spans the leaf's own [min, max], so the
    error an element is at most ``(max - min) / 255``; a constant leaf
    encodes with scale 0 and decodes exactly."""

    name = "int8"
    lossy = True
    _LEVELS = 255
    _pull = Fp16Codec()

    def encode(self, arr, kind: str = "commit"):
        if not _is_float(arr.dtype):
            return leaf_buffer(arr)
        if kind == "pull":
            return self._pull.encode(arr, kind)
        a = np.asarray(arr, dtype=np.float32).reshape(-1)
        if a.size == 0:
            return b""
        lo, hi = float(a.min()), float(a.max())
        scale = float(affine_qparams(lo, hi, self._LEVELS))
        q = affine_quantize(a, np.float32(lo), np.float32(scale),
                            self._LEVELS)
        head = np.array([scale, lo], dtype="<f4").tobytes()
        return head + q.astype(np.uint8).tobytes()

    def decode(self, blob, shape, dtype, kind: str = "commit"):
        if not _is_float(dtype):
            return _from_bytes(blob, dtype, shape)
        if kind == "pull":
            return self._pull.decode(blob, shape, dtype, kind)
        n = int(np.prod(shape))
        if n == 0:
            return np.zeros(shape, dtype)
        if len(blob) != 8 + n:
            raise ValueError(
                f"int8 blob of {len(blob)} bytes does not match leaf "
                f"shape {shape} (want {8 + n})")
        scale, lo = np.frombuffer(blob[:8], dtype="<f4")
        q = np.frombuffer(blob, dtype=np.uint8, offset=8)
        return affine_dequantize(
            q.astype(np.float32), np.float32(lo),
            np.float32(scale)).reshape(shape).astype(dtype)


_REGISTRY: Dict[str, Codec] = {
    c.name: c for c in (RawCodec(), Fp16Codec(), Bf16Codec(), QuantCodec())
}


def available_codecs() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_codec(codec) -> Codec:
    """Resolve a codec by name (or pass a Codec instance through)."""
    if isinstance(codec, Codec):
        return codec
    try:
        return _REGISTRY[str(codec)]
    except KeyError:
        raise ValueError(f"Unknown codec {codec!r}; "
                         f"available: {available_codecs()}") from None


def negotiate(requested: str, supported: Iterable[str]) -> str:
    """Handshake rule of both ends: the server grants the requested codec
    when it supports it, else both fall back to raw (always legal)."""
    return requested if requested in set(supported) | {"raw"} else "raw"


class ErrorFeedback:
    """Worker-side residual accumulation for lossy commit codecs.

    ``encode_leaves`` adds to each float delta the residual left by the
    earlier encodes, encodes the sum, and banks the new quantization
    error: over a run, the sum of what the server decoded equals the sum
    of the true deltas to within one step's quantization error.
    Thread-safe: host_async worker threads share one client and so one
    residual stream; the lock serializes adjust + bank."""

    def __init__(self, codec: Codec):
        self.codec = get_codec(codec)
        self._residual: Optional[List[Optional[np.ndarray]]] = None
        self._lock = threading.Lock()

    def encode_leaves(self, leaves: Sequence[np.ndarray],
                      specs: Sequence[Spec]) -> list:
        if not self.codec.lossy:
            return [self.codec.encode(l, kind="commit") for l in leaves]
        with self._lock:
            if self._residual is None:
                self._residual = [
                    np.zeros(s, np.float32) if _is_float(d) else None
                    for s, d in specs]
            blobs = []
            for i, (leaf, (shape, dtype)) in enumerate(zip(leaves, specs)):
                res = self._residual[i]
                if res is None:  # integer leaf: exact under every codec
                    blobs.append(self.codec.encode(leaf, kind="commit"))
                    continue
                adj = np.asarray(leaf, np.float32) + res
                blob = self.codec.encode(adj, kind="commit")
                decoded = np.asarray(
                    self.codec.decode(bytes(blob), shape, dtype,
                                      kind="commit"), np.float32)
                self._residual[i] = adj - decoded
                blobs.append(blob)
            return blobs

    def reset(self) -> None:
        with self._lock:
            self._residual = None


class EncodedParameterServer:
    """A local ParameterServer whose every pull and commit crosses the
    codec exactly as it would on the wire, with no socket: a
    single-process ``codec=`` run sees the numerics a remote service
    would give it. Trees come and go as host numpy trees; the server
    moves a committed delta to its own device."""

    def __init__(self, ps, codec):
        self.ps = ps
        self.codec = get_codec(codec)
        self._ef = ErrorFeedback(self.codec)
        self._specs: Optional[List[Spec]] = None
        self._treedef = None

    def _flatten(self, tree):
        leaves, treedef = tree_flatten(to_host(tree))
        if self._specs is None:
            self._specs = [(l.shape, l.dtype) for l in leaves]
            self._treedef = treedef
        return leaves

    def _roundtrip(self, tree, kind: str):
        leaves = self._flatten(tree)
        if kind == "commit":
            blobs = self._ef.encode_leaves(leaves, self._specs)
        else:
            blobs = [self.codec.encode(l, kind=kind) for l in leaves]
        raw = sum(l.nbytes for l in leaves)
        wire = sum(len(b) for b in blobs)
        if wire:
            telemetry.histogram("comms.compress_ratio",
                                op=kind, path="local").record(raw / wire)
        out = [self.codec.decode(bytes(b), s, d, kind=kind)
               for b, (s, d) in zip(blobs, self._specs)]
        return tree_unflatten(self._treedef, out)

    # -- ParameterServer interface ---------------------------------------
    def pull(self):
        center, clock = self.ps.pull()
        if self.codec.name == "raw":
            return center, clock
        return self._roundtrip(center, "pull"), clock

    def commit(self, delta, last_update: int = 0) -> int:
        if self.codec.name == "raw":
            return self.ps.commit(delta, last_update=last_update)
        return self.ps.commit(self._roundtrip(delta, "commit"),
                              last_update=last_update)

    def initialize(self, params) -> None:
        self.ps.initialize(params)

    @property
    def num_updates(self) -> int:
        return self.ps.num_updates

    @num_updates.setter
    def num_updates(self, value: int) -> None:
        self.ps.num_updates = value

    def start(self) -> None:
        self.ps.start()

    def stop(self) -> None:
        self.ps.stop()
