"""The parameter-server wire format (port of the wire part of
``distkeras_tpu/parallel/remote_ps.py``; the service, its client and the
rest of the true-async plane are ROADMAP.md Queue A, item 13).

One framing for every socket of the repo, no pickle: nothing on the wire
can execute code, and leaves decode zero-copy into numpy::

    [u32 header_len][header JSON (utf-8)][blob 0][blob 1]...

``header["blob_lens"]`` carries the byte length of each trailing blob.
The serving front end (:mod:`distkeras_tpu_torch.serving.server`) speaks
it with the same shared-token check (:func:`check_token`), so a client of
either package talks to a server of the other.

:class:`_TreeCodec` moves a weight tree as one blob a leaf. The tree is
the flax layout the JAX package publishes (a nested mapping of numpy
arrays; :mod:`distkeras_tpu_torch.utils.bridge` converts a ``state_dict``
to and from it), flattened in the order ``jax.tree`` flattens dicts
(keys sorted at every level), so a JAX ``put_weights`` and the port's
produce the same bytes.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.comms.chunking import send_buffers
from distkeras_tpu_torch.comms.codec import get_codec


def send_message(sock: socket.socket, header: dict,
                 blobs: Sequence = ()):
    """Frame and send. Blobs may be bytes or memoryviews; large ones go
    out as bounded chunks straight from their backing arrays."""
    header = dict(header)
    header["blob_lens"] = [len(b) for b in blobs]
    hb = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hb)) + hb)
    send_buffers(sock, blobs)


def _recvexact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


def recv_message(sock: socket.socket) -> Tuple[dict, list]:
    (hlen,) = struct.unpack("<I", _recvexact(sock, 4))
    header = json.loads(_recvexact(sock, hlen))
    blobs = [_recvexact(sock, n) for n in header.get("blob_lens", [])]
    return header, blobs


def check_token(expected: Optional[str], header: dict) -> bool:
    """Constant-time shared-token check: a request whose header token
    does not match is refused. ``expected=None`` disables
    authentication (single-host development)."""
    if expected is None:
        return True
    import hmac

    got = header.get("token")
    return isinstance(got, str) and hmac.compare_digest(got, expected)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=()):
    """``(path, leaf)`` pairs in jax's dict order: keys sorted at every
    level."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _unflatten(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


class _TreeCodec:
    """Flatten/unflatten a fixed weight tree to wire leaf blobs.

    Both ends build the codec from their own tree of the same structure,
    so the wire carries only leaf blobs: structure, shapes and dtypes are
    agreed out of band and VERIFIED on decode. The leaf encoding is a
    wire codec (:mod:`distkeras_tpu_torch.comms.codec`, raw)."""

    def __init__(self, like, wire="raw"):
        flat = [(path, _host(leaf)) for path, leaf in _flatten(like)]
        self.paths = [path for path, _ in flat]
        self.specs = [(leaf.shape, leaf.dtype) for _, leaf in flat]
        self._raw_bytes = sum(
            int(np.prod(s)) * np.dtype(d).itemsize for s, d in self.specs)
        self.wire = get_codec(wire)

    def encode(self, tree, kind: str = "commit") -> list:
        t0 = time.perf_counter()
        leaves = [_host(leaf) for _, leaf in _flatten(tree)]
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"tree has {len(leaves)} leaves, codec expects "
                f"{len(self.specs)}")
        blobs = [self.wire.encode(leaf, kind=kind) for leaf in leaves]
        wire_bytes = sum(len(b) for b in blobs)
        if wire_bytes:
            telemetry.histogram("comms.compress_ratio", op=kind,
                                codec=self.wire.name).record(
                self._raw_bytes / wire_bytes)
        telemetry.histogram("profile.phase.encode_s", op=kind).record(
            time.perf_counter() - t0)
        return blobs

    def decode(self, blobs: Sequence[bytes], kind: str = "commit") -> dict:
        t0 = time.perf_counter()
        if len(blobs) != len(self.specs):
            raise ValueError(
                f"message has {len(blobs)} blobs, codec expects "
                f"{len(self.specs)}")
        leaves = [self.wire.decode(b, shape, dtype, kind=kind)
                  for b, (shape, dtype) in zip(blobs, self.specs)]
        tree = _unflatten(self.paths, leaves)
        telemetry.histogram("profile.phase.decode_s", op=kind).record(
            time.perf_counter() - t0)
        return tree


__all__ = ["send_message", "recv_message", "check_token"]
