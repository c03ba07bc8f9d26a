"""Chunked zero-copy buffer encoding for large leaves (port of
``distkeras_tpu/comms/chunking.py``).

The helpers expose leaves as ``memoryview``s over their existing storage
and hand them to the socket in bounded chunks, so the only copies left
are the kernel's. Any fixed-itemsize dtype is viewed as raw bytes.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

#: Per-sendall chunk bound: large enough to amortize syscalls, small enough
#: that no single kernel copy pins a multi-GB buffer.
DEFAULT_CHUNK_BYTES = 4 << 20


def leaf_buffer(arr) -> memoryview:
    """A zero-copy byte view of an array's storage (copy only if the input
    was non-contiguous). Works for any fixed-itemsize dtype, bf16 included."""
    a = np.ascontiguousarray(arr)
    flat = a.reshape(-1)  # view: `a` is contiguous
    if flat.dtype != np.uint8:
        flat = flat.view(np.uint8)
    return memoryview(flat)


def iter_chunks(buf, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Iterator[memoryview]:
    """Slice a buffer into bounded memoryview windows (no copies)."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    for lo in range(0, len(mv), chunk_bytes):
        yield mv[lo:lo + chunk_bytes]


def send_buffers(sock, buffers: Sequence, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """sendall a sequence of byte buffers in bounded chunks; returns the
    total bytes written. The caller frames the message (lengths travel in
    its header) — this is purely the copy-free egress."""
    total = 0
    for buf in buffers:
        for chunk in iter_chunks(buf, chunk_bytes):
            sock.sendall(chunk)
            total += len(chunk)
    return total


def write_buffers(fileobj, buffers: Sequence,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    """File counterpart of :func:`send_buffers` (checkpoint and
    serialization egress): stream buffers to ``fileobj.write`` without
    joining them."""
    total = 0
    for buf in buffers:
        for chunk in iter_chunks(buf, chunk_bytes):
            fileobj.write(chunk)
            total += len(chunk)
    return total
