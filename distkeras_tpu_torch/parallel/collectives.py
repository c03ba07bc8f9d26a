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

Two more moves cross processes, over the same group as the fold:

- :func:`all_gather_flat` gathers every process's tensors (the shards of a
  model axis that spans processes); a shard's gradient needs no
  reduce-scatter (every process of a row computes the row's whole
  gradient);
- :func:`hop` sends tensors to other processes and receives theirs as a
  ``torch.autograd.Function`` (JAX's ``ppermute`` and its transpose): the
  forward posts the sends and the receives, the backward sends each
  received tensor's gradient back and receives the gradients of the sent
  ones. A send is waited only at :func:`flush_hops`, after the backward:
  no process blocks on a peer that has not yet posted its receive.

The group is :func:`~distkeras_tpu_torch.parallel.distributed.fold_group`'s
for the tensors' device. Over gloo (host tensors, or ranks that share a
card) a card tensor is staged through the host. Over NCCL (every rank on a
card of its own) the card buffers move as they are: the fold all-reduces
them in place, the gather is ``all_gather_into_tensor``, and a hop's
sends and receives are one ``batch_isend_irecv`` group on NCCL's stream,
each receive waited on the compute stream before its first use.

Both backends match point-to-point messages by their order between two
ranks alone (no message carries a tag), so the hops' order is part of the
schedule: every process posts its hops in the schedule's order, and each
hop under grad mode takes the previous hop's token as its anchor, so that
the backward runs the hops of a step in exactly the reverse order on every
process, whatever order the autograd engine would pick among independent
nodes.
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

    Over :func:`distributed.fold_group
    <distkeras_tpu_torch.parallel.distributed.fold_group>`'s group: over
    NCCL the card buffer is all-reduced in place; over gloo a card
    tensor is staged through one pinned host buffer (copied to it,
    all-reduced there, copied back)."""
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
            if flat.is_cuda and backend == "gloo":
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


#: dtypes neither gloo nor NCCL carries: gathered as their bytes
_AS_BYTES = (torch.int16, torch.bool)


@torch.no_grad()
def all_gather_flat(tensors: Sequence[torch.Tensor]) -> list:
    """Every process's ``tensors`` (the same count, shapes and dtypes on
    every process), as a list a process in rank order of its tensors, on
    the devices of this process's: one all-gather a dtype over
    :func:`distributed.fold_group
    <distkeras_tpu_torch.parallel.distributed.fold_group>`'s group (over
    NCCL on the card, ``all_gather_into_tensor``; over gloo a card's
    tensors staged through one pinned host buffer), int16 and bool as
    their bytes. Outside a group: ``[list(tensors)]``."""
    tensors = list(tensors)
    if distributed.process_count() == 1:
        return [tensors]
    cards = [t.device for t in tensors if t.is_cuda]
    group, backend = distributed.fold_group(cards[0] if cards else None)
    count = distributed.process_count()
    out = [[None] * len(tensors) for _ in range(count)]
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idxs in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        wire = flat.view(torch.uint8) if dtype in _AS_BYTES else flat
        if backend == "nccl":
            whole = torch.empty(count * wire.numel(), dtype=wire.dtype,
                                device=wire.device)
            torch.distributed.all_gather_into_tensor(whole, wire,
                                                     group=group)
            parts = whole.chunk(count)
        else:
            host = wire
            if wire.is_cuda:
                host = _staging(wire.numel(), wire.dtype)
                host.copy_(wire)
            parts = [torch.empty_like(host) for _ in range(count)]
            torch.distributed.all_gather(parts, host, group=group)
        for r, part in enumerate(parts):
            part = part.to(flat.device).view(dtype)
            at = 0
            for i in idxs:
                t = tensors[i]
                out[r][i] = part[at:at + t.numel()].view(t.shape)
                at += t.numel()
    return out


#: sends a hop posted whose completion is waited at flush_hops, with
#: the buffers they read
_PENDING: list = []

#: the token of this step's last hop under grad mode (the next hop's
#: anchor); reset by new_chain and flush_hops
_CHAIN: list = []


def new_chain() -> None:
    """Start a step's chain of hops (every process at the same point)."""
    _CHAIN.clear()


def _exchange(sends, recvs) -> list:
    """Post ``sends`` (``(tensor, dst)``) and ``recvs`` (``(src, shape,
    dtype, device)``) and return the received tensors, each ready on its
    device's current stream. Over NCCL (:func:`distributed.fold_group
    <distkeras_tpu_torch.parallel.distributed.fold_group>` of the cards)
    one ``batch_isend_irecv`` group on the card buffers; over gloo the
    sends leave from host copies and each receive is waited in turn. The
    sends are waited at :func:`flush_hops`."""
    dist = torch.distributed
    cards = [t.device for t, _ in sends if t.is_cuda] + [
        torch.device(d) for *_, d in recvs if torch.device(d).type == "cuda"]
    group, backend = distributed.fold_group(cards[0] if cards else None)
    if backend == "nccl":
        keep = [t.detach().contiguous() for t, _ in sends]
        got = [torch.empty(tuple(shape), dtype=dtype, device=device)
               for _, shape, dtype, device in recvs]
        ops = [dist.P2POp(dist.isend, t, int(dst), group)
               for t, (_, dst) in zip(keep, sends)] + [
            dist.P2POp(dist.irecv, g, int(src), group)
            for g, (src, *_) in zip(got, recvs)]
        with torch.cuda.device(cards[0]):
            works = dist.batch_isend_irecv(ops) if ops else []
            for work in works:
                work.wait()  # the current stream waits for NCCL's
        _PENDING.extend((work, keep) for work in works)
        return got
    for t, dst in sends:
        # a host copy of its own, which gloo keeps until the send completes
        host = t.detach().to("cpu", copy=True).contiguous()
        _PENDING.append((dist.isend(host, int(dst)), host))
    got = []
    for src, shape, dtype, device in recvs:
        host = torch.empty(tuple(shape), dtype=dtype)
        dist.irecv(host, int(src)).wait()
        got.append(host.to(device))
    return got


def flush_hops() -> None:
    """Wait for every send the hops posted and end the step's chain (call
    after the backward that closes a step, on every process)."""
    _CHAIN.clear()
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


class _Hop(torch.autograd.Function):
    """``forward(ctx, plan, anchor, *sends) -> (token, *received)``
    (:func:`hop`)."""

    @staticmethod
    def forward(ctx, plan, anchor, *sends):
        ctx.plan = plan
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sends]
        got = _exchange(list(zip(sends, plan[0])), list(plan[1]))
        ctx.mark_non_differentiable(*[g for g in got
                                      if not g.is_floating_point()])
        return (anchor.new_zeros(()), *got)

    @staticmethod
    def backward(ctx, token_grad, *grads):
        sends, recvs = ctx.plan
        back = iter(_exchange(
            [(g, src) for g, (src, _, dtype, _) in zip(grads, recvs)
             if dtype.is_floating_point],
            [(dst, shape, dtype, device)
             for dst, (shape, dtype, device) in zip(sends, ctx.sent)
             if dtype.is_floating_point]))
        # the anchor's gradient is zero: the edge only orders the hops
        return (None, torch.zeros_like(token_grad),
                *[next(back) if dtype.is_floating_point else None
                  for _, dtype, _ in ctx.sent])


def hop(sends: Sequence[tuple] = (), recvs: Sequence[tuple] = ()) -> tuple:
    """Move tensors between processes, differentiably: ``sends`` are
    ``(tensor, dst_process)``, ``recvs`` ``(src_process, shape, dtype,
    device)``; between two processes the receives take the sends in the
    order they were posted (module docstring). Returns ``(token,
    received)``: ``received`` in ``recvs``' order, and ``token`` a zero
    scalar that a process whose hop only sends adds to what it calls
    backward on, so that the hop's backward runs and receives the
    gradients of what it sent. Under grad mode each hop's anchor is the
    previous hop's token, so the backward runs a step's hops in reverse
    order. Under grad mode every floating tensor of a hop must take part
    in the backward on both sides (both processes call it); a send's
    completion is waited at :func:`flush_hops`."""
    plan = (tuple(int(dst) for _, dst in sends),
            tuple((int(src), tuple(shape), dtype, torch.device(device))
                  for src, shape, dtype, device in recvs))
    grad = torch.is_grad_enabled()
    anchor = _CHAIN[-1] if grad and _CHAIN else torch.zeros(
        (), requires_grad=grad)
    out = _Hop.apply(plan, anchor, *[t for t, _ in sends])
    if grad:
        _CHAIN[:] = [out[0]]
    return out[0], list(out[1:])
