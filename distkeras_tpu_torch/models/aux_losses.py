"""Sown auxiliary losses (the port of flax's ``sow("losses", ...)`` and
the JAX engine's ``mutable=["losses"]``).

A module adds a scalar term to the objective with :func:`sow` (the
Switch-MoE load-balance term, already scaled by its own weight). The step
engine opens a collector around each forward with :func:`collect` and
adds every term it caught to the loss, so every trainer gets the terms
through ``engine.make_grad_fn``, as in the JAX package.

The collector is thread-local: worker threads that run forwards at once
(``mode="host_async"``) each see only their own terms. Outside a
collector (serving, evaluation, a plain ``model(x)``) :func:`sow` drops
its term, as flax drops a sow into a collection that is not mutable.
A block that activation rematerialization recomputes in the backward
pass runs under :func:`suppressed`, so its terms count once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

import torch

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack, _local.suppressed = [], 0
    return _local.stack


@contextlib.contextmanager
def collect() -> Iterator[List[torch.Tensor]]:
    """Collect the terms sown in this thread until the block ends: the
    yielded list receives each term in the order it was sown."""
    stack = _stack()
    terms: List[torch.Tensor] = []
    stack.append(terms)
    try:
        yield terms
    finally:
        stack.pop()


@contextlib.contextmanager
def suppressed() -> Iterator[None]:
    """Drop every term sown in this thread until the block ends (a
    rematerialized block's second forward)."""
    _stack()
    _local.suppressed += 1
    try:
        yield
    finally:
        _local.suppressed -= 1


def sow(term: torch.Tensor) -> None:
    """Add ``term`` to the innermost open collector of this thread; a
    no-op outside one and under :func:`suppressed`."""
    stack = _stack()
    if stack and not _local.suppressed:
        stack[-1].append(term)
