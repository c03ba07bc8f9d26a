"""KV-cache pools for generative serving (port of
``distkeras_tpu/serving/kv_cache.py``: ``KVCachePool``,
``PagedKVCachePool`` and the host-RAM ``PrefixCache``).

Device state is a per-layer ``{"k", "v"}`` tuple of tensors, updated IN
PLACE by each step, where the JAX package donates the pool and installs
the returned one. The tensors are allocated once and never replaced: the
engine's CUDA graphs hold their addresses, so neither pool has a
``swap``.

- :class:`KVCachePool` (the rectangular pool, the engine's default):
  ``[num_slots + 1, max_len, heads, head_dim]``
  (:func:`~distkeras_tpu_torch.models.gpt.init_cache`). Row ``s`` is slot
  ``s``'s full-context cache; the extra last row is the scratch slot
  padded decode lanes read and write.
- :class:`PagedKVCachePool`: ``[num_pages + 1, page_size, heads,
  head_dim]`` (:func:`~distkeras_tpu_torch.models.gpt.init_paged_cache`;
  the last page is scratch) behind a per-slot page table; under
  ``kv_dtype="int8"`` the pages hold int8 codes with one float32 scale a
  page and layer (``k_scale``/``v_scale``).
- :class:`PrefixCache`: host copies of parked KV pages, content-hashed
  by their tokens, LRU under a byte budget (pure host logic).

Host state is plain numpy owned by the scheduler thread (no locking):
per-slot lengths and the free list, and for the paged pool a
``[num_slots + 1, pages_per_slot]`` int32 page table whose unmapped
entries point at the scratch page, and the free page list. A paged slot
claims pages with :meth:`PagedKVCachePool.reserve` (all-or-nothing,
sized to ``prompt + max_new_tokens``); page exhaustion is the pool's
backpressure. On a CUDA device each constructor refuses a pool larger
than ``hbm_fraction`` of the card's memory.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from distkeras_tpu_torch import observability, telemetry
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models import gpt as gpt_lib


def _check_budget(what: str, cache_bytes: int, detail: str, device,
                  hbm_fraction: float, lower: str) -> None:
    stats = observability.hbm_stats(device)
    if stats and stats.get("limit_bytes"):
        budget = hbm_fraction * stats["limit_bytes"]
        if cache_bytes > budget:
            raise ValueError(
                f"{what} needs {cache_bytes} bytes ({detail}) but the "
                f"budget is {int(budget)} B ({hbm_fraction:.0%} of the "
                f"device limit {stats['limit_bytes']} B); lower {lower}")


class _SlotPool:
    """The slot lifecycle both pools share: per-slot lengths, the free
    list and the occupancy gauge; row ``num_slots`` is the scratch
    slot."""

    def _init_slots(self, model, num_slots: int, device) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(model.max_len)
        #: tokens cached per slot; index num_slots is the scratch slot
        self.lengths = np.zeros(self.num_slots + 1, np.int32)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._active = set()
        self._occupancy_g = telemetry.gauge("serving.decode.slot_occupancy")
        self._occupancy_g.set(0.0)

    @property
    def scratch_slot(self) -> int:
        """Row index padded decode lanes read/write (never a live slot)."""
        return self.num_slots

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return len(self._active)

    def allocate(self) -> Optional[int]:
        """Claim a free slot (length reset to 0), or None when exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._active.add(slot)
        self.lengths[slot] = 0
        self._occupancy_g.set(self.num_active / self.num_slots)
        return slot

    def free(self, slot: int) -> None:
        """Return a slot. Stale cells need no scrubbing: every read is
        masked by the slot's (reset) length."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        self._active.remove(slot)
        self.lengths[slot] = 0
        self._free.append(slot)
        self._occupancy_g.set(self.num_active / self.num_slots)


class KVCachePool(_SlotPool):
    """Rectangular slot pool: one full-context cache row a slot, plus
    the scratch row."""

    def __init__(self, model, num_slots: int, *, device=None, dtype=None,
                 hbm_fraction: float = 0.8):
        self._init_slots(model, num_slots, device)
        per_row = gpt_lib.cache_bytes_per_row(model, dtype)
        self.cache_bytes = per_row * (self.num_slots + 1)
        _check_budget("KV cache pool", self.cache_bytes,
                      f"{self.num_slots}+1 rows x {per_row} B/row",
                      self.device, hbm_fraction, "num_slots or max_len")
        #: the cache rows, updated in place by every step
        self.pool = gpt_lib.init_cache(model, self.num_slots + 1, dtype,
                                       device=self.device)
        telemetry.gauge("serving.decode.cache_bytes").set(self.cache_bytes)


class PagedKVCachePool(_SlotPool):
    """Page-granular KV pool: slot -> page-table indirection over a
    shared page pool."""

    def __init__(self, model, num_slots: int, *, page_size: int = 16,
                 num_pages: Optional[int] = None, device=None,
                 dtype=None, kv_dtype: Optional[str] = None,
                 hbm_fraction: float = 0.8):
        if kv_dtype not in (None, "native", "int8"):
            raise ValueError(
                f"kv_dtype must be None, 'native', or 'int8', got "
                f"{kv_dtype!r}")
        self._init_slots(model, num_slots, device)
        #: page format: "native" (the compute dtype) or "int8" (codes and
        #: per-page float32 scales, models/gpt.py quantize_kv_page)
        self.kv_dtype = "int8" if kv_dtype == "int8" else "native"
        self.page_size = int(page_size)
        if self.page_size < 1 or self.max_len % self.page_size:
            raise ValueError(
                f"page_size must divide max_len ({self.max_len}), got "
                f"{self.page_size}")
        #: page-table width: pages a full-context slot needs
        self.pages_per_slot = self.max_len // self.page_size
        if num_pages is None:
            num_pages = self.num_slots * self.pages_per_slot
        self.num_pages = int(num_pages)
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} cannot back even one "
                f"full-context slot ({self.pages_per_slot} pages)")
        self.page_bytes = gpt_lib.page_bytes(model, self.page_size, dtype,
                                             kv_dtype=kv_dtype)
        self.cache_bytes = self.page_bytes * (self.num_pages + 1)
        #: bytes int8 pages save against native pages at this geometry
        self.kv_quant_bytes_saved = 0
        if self.kv_dtype == "int8":
            native = gpt_lib.page_bytes(model, self.page_size, dtype)
            self.kv_quant_bytes_saved = (
                (native - self.page_bytes) * (self.num_pages + 1))
        _check_budget("paged KV pool", self.cache_bytes,
                      f"{self.num_pages}+1 pages x {self.page_bytes} B/page",
                      self.device, hbm_fraction, "num_pages or page_size")
        #: the page tensors, updated in place by every step
        self.pool = gpt_lib.init_paged_cache(model, self.num_pages,
                                             self.page_size, dtype,
                                             kv_dtype=kv_dtype,
                                             device=self.device)
        #: slot -> page-table rows; unmapped entries = scratch page
        self.page_tables = np.full(
            (self.num_slots + 1, self.pages_per_slot), self.scratch_page,
            np.int32)
        self._free_pages = list(range(self.num_pages - 1, -1, -1))
        self._reserved: dict = {}  # slot -> [page ids]
        telemetry.gauge("serving.decode.cache_bytes").set(self.cache_bytes)
        self._pages_c = telemetry.counter(
            "serving.decode.paged.pages_allocated")
        self._page_occ_g = telemetry.gauge(
            "serving.decode.paged.page_occupancy")
        self._page_occ_g.set(0.0)
        if self.kv_dtype == "int8":
            telemetry.gauge(
                "serving.decode.paged.kv_quant_bytes_saved").set(
                    self.kv_quant_bytes_saved)

    # -- slot/page lifecycle ----------------------------------------------

    @property
    def scratch_page(self) -> int:
        """Physical page unmapped table entries and overflow writes hit."""
        return self.num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages)

    def pages_for(self, tokens: int) -> int:
        """Pages a ``tokens``-long context occupies (ceil division)."""
        return -(-int(tokens) // self.page_size)

    def reserve(self, slot: int, tokens: int) -> bool:
        """All-or-nothing: map enough pages onto ``slot`` to hold
        ``tokens`` cells. False (nothing claimed) when the pool can't
        cover it — the scheduler leaves the request queued. Writes past
        the reservation route to the scratch page."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        need = self.pages_for(tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"{tokens} tokens need {need} pages, above the "
                f"{self.pages_per_slot}-page table width")
        have = len(self._reserved.get(slot, ()))
        grow = need - have
        if grow <= 0:
            return True
        if grow > len(self._free_pages):
            return False
        pages = [self._free_pages.pop() for _ in range(grow)]
        self._reserved.setdefault(slot, []).extend(pages)
        self.page_tables[slot, have:need] = pages
        self._pages_c.inc(grow)
        self._page_occ_g.set(self.pages_in_use / self.num_pages)
        return True

    def free(self, slot: int) -> None:
        """Return a slot and its pages. Stale cells need no scrubbing:
        reads are masked by the (reset) length and cells are overwritten
        before the mask unhides them."""
        super().free(slot)
        self._free_pages.extend(reversed(self._reserved.pop(slot, [])))
        self.page_tables[slot, :] = self.scratch_page
        self._page_occ_g.set(self.pages_in_use / self.num_pages)

    def page_table_row(self, slot: int) -> np.ndarray:
        """Copy of ``slot``'s page-table row (what a step gets)."""
        return self.page_tables[slot].copy()


def tree_leaves(tree) -> list:
    """Leaves of a per-layer ``{name: array}`` tuple in the JAX package's
    pytree order (layers in turn, each layer's keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


class _PrefixEntry:
    __slots__ = ("tokens", "length", "data", "last_logits", "nbytes")

    def __init__(self, tokens, length, data, last_logits, nbytes):
        self.tokens = tokens            # tuple of cached token ids
        self.length = length            # cached positions [0, length)
        self.data = data                # host page data (swap-out copy)
        self.last_logits = last_logits  # np [V] after `tokens`, or None
        self.nbytes = nbytes


class PrefixCache:
    """Host-RAM KV prefix store: content-hashed reuse of prefill work.

    An entry is a token sequence plus the host copy of the pages that
    hold its K/V (the engine's swap-out gather: on the card page-locked
    CPU tensors in the pool's own dtype) and, when the entry covers a
    full request, the logits
    after its last token, so that a full hit emits the first token with
    no model call. Keys are ``hash(tokens[:L])`` per cached length;
    lookup walks cached lengths longest first and checks the tokens
    themselves (a hash collision is a miss, never a wrong row). Eviction
    is LRU under ``budget_bytes`` of host RAM, charged at buffer size.

    Owned by the engine's scheduler thread; no locking.
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.bytes = 0
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._lengths: collections.Counter = collections.Counter()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._hits_c = telemetry.counter("serving.decode.prefix.hits")
        self._misses_c = telemetry.counter("serving.decode.prefix.misses")
        self._evict_c = telemetry.counter("serving.decode.prefix.evictions")
        self._inserts_c = telemetry.counter("serving.decode.prefix.inserts")
        self._bytes_g = telemetry.gauge("serving.decode.prefix.bytes")
        self._bytes_g.set(0)
        self._rate_g = telemetry.gauge("serving.decode.prefix.hit_rate")

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @staticmethod
    def _key(tokens) -> tuple:
        return (len(tokens), hash(tokens))

    def has(self, tokens) -> bool:
        """Exact-sequence membership (no hit/miss accounting, no LRU
        refresh): the capture path's don't-repark check."""
        return self.peek(tokens) is not None

    def peek(self, tokens) -> Optional[_PrefixEntry]:
        """Exact-sequence fetch with no hit/miss accounting and no LRU
        refresh (the export path reads an entry to ship it)."""
        tokens = tuple(int(t) for t in tokens)
        entry = self._entries.get(self._key(tokens))
        if entry is not None and entry.tokens == tokens:
            return entry
        return None

    def lookup(self, prompt) -> Optional[_PrefixEntry]:
        """Longest cached prefix of ``prompt`` (LRU-refreshed), or None.
        A hit when any prefix matches; the engine decides full hit or
        tail prefill from ``entry.length``."""
        prompt = tuple(int(t) for t in prompt)
        for ln in sorted({n for n in self._lengths if n <= len(prompt)},
                         reverse=True):
            key = self._key(prompt[:ln])
            entry = self._entries.get(key)
            if entry is not None and entry.tokens == prompt[:ln]:
                self._entries.move_to_end(key)
                self.hits += 1
                self._hits_c.inc()
                self._rate_g.set(self.hit_rate)
                return entry
        self.misses += 1
        self._misses_c.inc()
        self._rate_g.set(self.hit_rate)
        return None

    def insert(self, tokens, data, last_logits=None) -> None:
        """Store ``data`` (host page data) as the KV for ``tokens``,
        evicting LRU entries to stay under budget. An entry larger than
        the whole budget is refused (counted as an eviction of itself)."""
        tokens = tuple(int(t) for t in tokens)
        nbytes = sum(leaf.nbytes for leaf in tree_leaves(data))
        if last_logits is not None:
            last_logits = np.asarray(last_logits)
            nbytes += last_logits.nbytes
        if nbytes > self.budget_bytes:
            self.evictions += 1
            self._evict_c.inc()
            return
        key = self._key(tokens)
        old = self._entries.pop(key, None)
        if old is not None:
            self._forget(old)
        while self.bytes + nbytes > self.budget_bytes and self._entries:
            self._drop(self._entries.popitem(last=False)[1])
        self._entries[key] = _PrefixEntry(tokens, len(tokens), data,
                                          last_logits, nbytes)
        self._lengths[len(tokens)] += 1
        self.bytes += nbytes
        self._inserts_c.inc()
        self._bytes_g.set(self.bytes)

    def evict(self, entry: _PrefixEntry) -> None:
        """Drop one entry (a restore that failed must not be offered
        again)."""
        if self._entries.pop(self._key(entry.tokens), None) is not None:
            self._drop(entry)

    def _forget(self, entry: _PrefixEntry) -> None:
        self.bytes -= entry.nbytes
        self._lengths[entry.length] -= 1
        if not self._lengths[entry.length]:
            del self._lengths[entry.length]

    def _drop(self, entry: _PrefixEntry) -> None:
        self._forget(entry)
        self.evictions += 1
        self._evict_c.inc()
        self._bytes_g.set(self.bytes)
