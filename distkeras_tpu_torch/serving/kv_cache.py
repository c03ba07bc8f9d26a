"""KV-cache pools for generative serving (port of
``distkeras_tpu/serving/kv_cache.py``: ``KVCachePool`` and
``PagedKVCachePool``).

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
  the last page is scratch) behind a per-slot page table.

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
        self._init_slots(model, num_slots, device)
        if kv_dtype == "int8":
            raise NotImplementedError(
                "int8 KV pages are not ported yet (ROADMAP.md Queue A, "
                "item 5)")
        if kv_dtype not in (None, "native"):
            raise ValueError(
                f"kv_dtype must be None, 'native', or 'int8', got "
                f"{kv_dtype!r}")
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
        self.page_bytes = gpt_lib.page_bytes(model, self.page_size, dtype)
        self.cache_bytes = self.page_bytes * (self.num_pages + 1)
        _check_budget("paged KV pool", self.cache_bytes,
                      f"{self.num_pages}+1 pages x {self.page_bytes} B/page",
                      self.device, hbm_fraction, "num_pages or page_size")
        #: the page tensors, updated in place by every step
        self.pool = gpt_lib.init_paged_cache(model, self.num_pages,
                                             self.page_size, dtype,
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
