"""Ring attention (port of ``distkeras_tpu/ops/ring_attention.py``):
sequence parallelism over the shards of a ``seq`` axis.

The sequence is cut into P blocks, block ``i`` on shard ``i``'s device.
Each shard keeps its query block and folds every key/value block into
a flash-style online softmax (running max ``m``, normalizer ``l``,
unnormalized output ``o``, all float32), so a shard never holds more
than a ``[B, H, T/P, T/P]`` block of logits.

In the JAX package the k/v blocks ride ``ppermute`` around the ring
inside ``shard_map``. In the port, after each fold the k/v blocks (and
``kv_mask``) hop to the next shard's device: with ``.to()`` between
shards of one process (a no-op copy where a mesh repeats a device), and
through :func:`~distkeras_tpu_torch.parallel.collectives.hop` (a
``torch.autograd.Function``: send and receive over gloo or NCCL, its
backward the ``ppermute``'s transpose; every process posts a ring's hops
in the same order, since messages are matched by their order) where the next
shard is another process's.
A shard another process holds is a :class:`Remote` in the block lists:
each process folds only its own blocks, in the same order as one process
folds them all, so its outputs are the one-process ring's bits. There
are P - 1 hops; the last fold has no wrap-around hop, as in JAX. The fold is torch ops, as JAX's is jnp:
there is no Pallas kernel on this path.

Arithmetic mirrors the JAX function: ``q . k`` in the input dtype, then
float32 and the scale; masks are a true ``-inf`` with the ``isfinite``
guards (a fully masked block, a causal block from the future, leaves
the accumulators as they were and gives zero gradients, not NaN); a row
that no key reaches gives 0; the output is cast to ``q``'s dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from distkeras_tpu_torch.parallel import collectives


class Remote:
    """A sequence shard that another process (``rank``) holds: its place
    in the block lists of :func:`ring_attention` and of gpt's ring
    forward."""

    __slots__ = ("rank",)

    def __init__(self, rank: int):
        self.rank = int(rank)

    def __repr__(self) -> str:
        return f"Remote({self.rank})"


def is_remote(x) -> bool:
    return isinstance(x, Remote)


def _hop_blocks(kinds: Sequence[list], num: int) -> list:
    """The ``ppermute`` i -> i + 1 of each list of ``kinds`` (blocks of
    k, v, mask): shard ``i`` then holds shard ``i - 1``'s block, moved
    with ``.to()`` inside this process and through one
    :func:`collectives.hop` for the blocks that cross to or from
    another process's shard."""
    first = kinds[0]
    out = [[None] * num for _ in kinds]
    sends, recvs, slots = [], [], []
    for i in range(num):
        src = (i - 1) % num
        if is_remote(first[i]):
            if not is_remote(first[src]):  # this process's block leaves
                for blocks in kinds:
                    sends.append((blocks[src], first[i].rank))
            for c in range(len(kinds)):
                out[c][i] = first[i]
            continue
        if not is_remote(first[src]):
            for c, blocks in enumerate(kinds):
                out[c][i] = blocks[src].to(first[i].device)
            continue
        for c, blocks in enumerate(kinds):  # the block arrives
            like = blocks[i]
            recvs.append((first[src].rank, like.shape, like.dtype,
                          like.device))
            slots.append((c, i))
    if sends or recvs:
        _, got = collectives.hop(sends, recvs)
        for (c, i), t in zip(slots, got):
            out[c][i] = t
    return out


def _block_update(logits, m, l, o, v):
    """Fold one ``[B, H, Tq, Tk]`` logit block into the ``(m, l, o)``
    accumulators (``m``, ``l``: ``[B, H, Tq]``; ``o``: ``[B, Tq, H, D]``)."""
    block_max = logits.amax(dim=-1)
    m_new = torch.maximum(m, block_max)
    # rows masked so far stay at -inf but must not give (-inf) - (-inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, 0.0)
    corr = torch.exp(m - m_safe)
    corr = torch.where(torch.isfinite(m), corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    corr_o = corr.transpose(1, 2)[..., None]
    o_new = o * corr_o + torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o_new


def _fold(q, k, v, idx, src, causal, kv_mask, acc):
    """Fold global block ``src`` (held as ``k``/``v``) into shard
    ``idx``'s accumulators."""
    scale = q.shape[-1] ** -0.5
    tq, tk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = idx * tq + torch.arange(tq, device=q.device)
        k_pos = src * tk + torch.arange(tk, device=q.device)
        allowed = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(allowed, logits, float("-inf"))
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits,
                             float("-inf"))
    return _block_update(logits, *acc, v)


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor], causal: bool = False,
                   kv_mask: Optional[Sequence[torch.Tensor]] = None) -> list:
    """Attention with q/k/v cut into P sequence blocks, block ``i`` of
    each on shard ``i``'s device (the JAX function's per-device view,
    for every shard at once).

    ``q[i]``: ``[B, Tq, H, D]``; ``k[i]``/``v[i]``: ``[B, Tk, H, D]``;
    ``kv_mask[i]``: ``[B, Tk]`` bool (padding), or None. Block order
    follows global positions. Returns the P output blocks, each on its
    shard's device in ``q[i]``'s dtype. A block another process holds is
    a :class:`Remote` in every list (and in the output): that process
    calls this function with the same lists, its own blocks in them.
    """
    num = len(q)
    if not (len(k) == len(v) == num) or (kv_mask is not None
                                         and len(kv_mask) != num):
        raise ValueError("q, k, v (and kv_mask) need one block a shard")
    acc = []
    for qi in q:
        if is_remote(qi):
            acc.append(None)
            continue
        b, tq, h, d = qi.shape
        acc.append((
            torch.full((b, h, tq), float("-inf"), dtype=torch.float32,
                       device=qi.device),
            torch.zeros((b, h, tq), dtype=torch.float32, device=qi.device),
            torch.zeros((b, tq, h, d), dtype=torch.float32,
                        device=qi.device)))
    held_k, held_v = list(k), list(v)
    held_mask = None if kv_mask is None else list(kv_mask)
    for step in range(num):
        for i in range(num):
            if is_remote(q[i]):
                continue
            mask_i = None if held_mask is None else held_mask[i]
            acc[i] = _fold(q[i], held_k[i], held_v[i], i,
                           (i - step) % num, causal, mask_i, acc[i])
        if step == num - 1:
            break  # the wrap-around hop would be discarded
        # the ppermute i -> i + 1: shard i now holds shard i - 1's block
        kinds = [held_k, held_v] + ([] if held_mask is None else [held_mask])
        moved = _hop_blocks(kinds, num)
        held_k, held_v = moved[0], moved[1]
        if held_mask is not None:
            held_mask = moved[2]
    out = []
    for qi, a in zip(q, acc):
        if a is None:
            out.append(qi)
            continue
        _, l, o = a
        l_o = l.transpose(1, 2)[..., None]
        out.append(torch.where(l_o > 0, o / torch.clamp(l_o, min=1e-30),
                               0.0).to(qi.dtype))
    return out


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, axis_name: str = "seq",
                           causal: bool = False,
                           kv_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Global ``[B, T, H, D]`` q/k/v (and ``[B, T]`` ``kv_mask``) cut
    into blocks over ``mesh``'s ``axis_name`` devices (a
    :class:`~distkeras_tpu_torch.parallel.mesh.Mesh`, e.g. from
    :func:`~distkeras_tpu_torch.parallel.sequence.make_sp_mesh`), run
    through :func:`ring_attention`, and joined on ``q``'s device."""
    if mesh.spans_processes:
        raise ValueError(
            "ring_attention_sharded joins the blocks in one process; over "
            "processes call ring_attention with Remote blocks")
    devices = mesh.axis_devices(axis_name)
    num = len(devices)
    if q.shape[1] % num or k.shape[1] % num:
        raise ValueError(f"sequence lengths {q.shape[1]}, {k.shape[1]} do "
                         f"not split over {num} {axis_name!r} shards")

    def split(x):
        return [c.to(dev) for c, dev in zip(x.chunk(num, dim=1), devices)]

    out = ring_attention(split(q), split(k), split(v), causal=causal,
                         kv_mask=None if kv_mask is None else split(kv_mask))
    return torch.cat([o.to(q.device) for o in out], dim=1)
