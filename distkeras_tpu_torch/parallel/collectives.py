"""Gradient-bucket folds (port of ``distkeras_tpu/parallel/collectives.py``).

The JAX package issues its data-parallel gradient ``psum`` as one
collective per size-targeted bucket, so that each bucket's all-reduce
can start while the rest of the backward runs. In one process the
workers' gradients are name -> tensor dicts, one a worker, and the fold
is their sum: :func:`bucketed_psum` sums them leaf by leaf, bucket by
bucket, in :func:`partition_buckets`' order. Each leaf's sum is the same
operations whichever bucket it falls in, so the bucketed fold is bitwise
the whole-tree fold, as the JAX package's test states for its psums.

Buckets walk the REVERSED leaf order (roughly the order in which a
backward pass finishes the gradients: the head's first).

Across processes (:func:`cross_process_sum`) each process first folds its
own workers in worker order into a partial; the partials are then
all-reduced over :func:`~distkeras_tpu_torch.parallel.distributed.fold_group`,
one collective a bucket of the same buckets. With one worker a process,
or whenever the partials' order of additions is the one-process fold's,
the result is the one-process fold's bits; else it differs by the
reassociation of a float32 sum.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from distkeras_tpu_torch.parallel import distributed


def partition_buckets(nbytes: Sequence[int],
                      bucket_bytes: int) -> List[List[int]]:
    """Greedy size-targeted grouping of leaf indices, in REVERSED index
    order.

    Each bucket accumulates leaves until it holds at least
    ``bucket_bytes``; the final (tail) bucket may be ragged, smaller than
    the target, rather than merged backward. Every index appears exactly
    once; a leaf larger than the target gets its own bucket."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: List[List[int]] = []
    cur: List[int] = []
    size = 0
    for i in reversed(range(len(nbytes))):
        cur.append(i)
        size += int(nbytes[i])
        if size >= bucket_bytes:
            buckets.append(cur)
            cur, size = [], 0
    if cur:
        buckets.append(cur)  # ragged tail
    return buckets


def _fold(trees: Sequence[dict], names: Sequence[str], home: dict) -> dict:
    """The workers' leaves ``names`` summed in worker order, each on the
    device of ``home``'s (the first worker's) leaf."""
    out = {}
    for n in names:
        total = home[n]
        for tree in trees[1:]:
            total = total + tree[n].to(total.device)
        out[n] = total
    return out


@torch.no_grad()
def bucketed_psum(trees: Sequence[dict],
                  bucket_bytes: Optional[int] = None) -> dict:
    """The sum over workers of ``trees`` (one name -> tensor dict a
    worker, all with the same names, shapes and dtypes), leaf by leaf in
    worker order, each sum on the first worker's device. With
    ``bucket_bytes`` the leaves are summed one bucket at a time in
    :func:`partition_buckets`' order; ``None`` sums the whole tree at
    once. Both give the same bits."""
    if not trees:
        raise ValueError("bucketed_psum needs at least one worker's tree")
    names = list(trees[0])
    if any(list(t) != names for t in trees[1:]):
        raise ValueError("every worker's gradient tree must hold the same "
                         "leaves in the same order")
    if bucket_bytes is None or not names:
        return _fold(trees, names, trees[0])
    sizes = [t.numel() * t.element_size() for t in trees[0].values()]
    out = {}
    for idxs in partition_buckets(sizes, bucket_bytes):
        out.update(_fold(trees, [names[i] for i in idxs], trees[0]))
    return {n: out[n] for n in names}


#: the pinned host buffer gloo folds of card tensors are staged through
_STAGING: dict = {}


def _staging(numel: int, dtype: torch.dtype) -> torch.Tensor:
    """One pinned host buffer a dtype, grown to the largest bucket."""
    buf = _STAGING.get(dtype)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        _STAGING[dtype] = buf
    return buf[:numel]


@torch.no_grad()
def cross_process_sum(tree: dict, bucket_bytes: Optional[int] = None) -> dict:
    """The sum over processes of ``tree`` (name -> tensor, the same names,
    shapes and dtypes on every process), every process getting the same
    bits: one all-reduce a bucket (:func:`partition_buckets`' buckets
    under ``bucket_bytes``, the whole tree as one bucket under None), each
    bucket's leaves of one dtype flattened into one buffer. Outside a
    group: ``tree`` unchanged.

    The fold runs over gloo (:func:`distributed.fold_group
    <distkeras_tpu_torch.parallel.distributed.fold_group>`, which raises
    for an NCCL fold across cards), so a card tensor is staged through one pinned host buffer: copied to
    it, all-reduced there, copied back. That is the one path for a card
    (gloo's collectives run on the host)."""
    cards = [t.device for t in tree.values() if t.is_cuda]
    group, backend = distributed.fold_group(cards[0] if cards else None)
    if backend is None:
        return dict(tree)
    names = list(tree)
    if bucket_bytes is None:
        buckets = [list(reversed(range(len(names))))]
    else:
        sizes = [t.numel() * t.element_size() for t in tree.values()]
        buckets = partition_buckets(sizes, bucket_bytes)
    out = {}
    for idxs in buckets:
        by_dtype: dict = {}
        for i in idxs:
            by_dtype.setdefault(tree[names[i]].dtype, []).append(names[i])
        for dtype, group_names in by_dtype.items():
            flat = torch.cat([tree[n].reshape(-1) for n in group_names])
            if flat.is_cuda:
                host = _staging(flat.numel(), dtype)
                host.copy_(flat)
                torch.distributed.all_reduce(host, group=group)
                flat.copy_(host)
            else:
                torch.distributed.all_reduce(flat, group=group)
            at = 0
            for n in group_names:
                t = tree[n]
                out[n] = flat[at:at + t.numel()].view(t.shape)
                at += t.numel()
    return {n: out[n] for n in names}
