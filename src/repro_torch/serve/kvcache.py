"""A copy of ``repro/serve/kvcache.py``.

Paged KV-cache bookkeeping: fixed-size pages, a free-list allocator and
per-slot page tables.

The device side is a shared *pool* per attention layer
(``lm.init_paged_cache``): ``num_pages + 1`` rows of ``page_size`` token
slots each.  The extra last row is the **trash page** — page-table entries
of empty or retired slots point at it, so the decode step can keep writing
unconditionally for every slot (no per-slot predication inside the
decode loop) while garbage lands outside every live request's pages.  Reads are
length-masked by the decode kernels, so the trash page's contents never
reach a logit.

The host side (this module) is pure Python/NumPy bookkeeping: which pages
are free, which slot owns which pages.  Allocation is all-or-nothing per
grant: under the default *reserve* admission mode a request reserves every
page it could ever need (``ceil((prompt + max_new) / page_size)``) up
front, so a running request can never hit a mid-flight out-of-pages
condition and preemption is never required.  Under *optimistic* admission
(`scheduler.Scheduler(mode="optimistic")`) a request reserves only
``ceil(prompt / page_size) + 1`` pages and the engine calls ``grow()`` at
decode-segment boundaries; a failed grow triggers youngest-first
preemption in the engine, never silent corruption — decode writes beyond a
slot's owned pages would land in the trash page and be lost, so coverage
must be ensured *before* the segment runs.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["PagedKvCache", "pages_needed"]


def pages_needed(num_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(num_tokens / page_size))


class PagedKvCache:
    """Free-list page allocator + per-slot page tables.

    ``table()`` materializes the (num_slots, max_pages_per_slot) int32 table
    the model functions consume; unassigned entries point at the
    trash page (index ``num_pages``)."""

    def __init__(self, num_slots: int, num_pages: int, page_size: int,
                 max_pages_per_slot: int):
        if page_size < 1 or num_pages < 1:
            raise ValueError("need at least one page of at least one token")
        self.num_slots = num_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.trash = num_pages          # sentinel: last pool row
        self._free = list(range(num_pages - 1, -1, -1))  # pop() → page 0 first
        self._owned: dict[int, list[int]] = {}
        self._table = np.full((num_slots, max_pages_per_slot), self.trash,
                              np.int32)

    # -- allocation ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate_pages(self, slot: int, n: int) -> list[int]:
        """Reserve exactly ``n`` pages for ``slot``.  All-or-nothing;
        raises if the slot is occupied or the grant cannot fit."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        if n > self.max_pages_per_slot:
            raise ValueError(
                f"request needs {n} pages > max_pages_per_slot "
                f"({self.max_pages_per_slot})")
        if n > len(self._free):
            raise ValueError(f"out of pages: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned[slot] = pages
        self._table[slot, :] = self.trash
        self._table[slot, :n] = pages
        return pages

    def grow(self, slot: int, n: int = 1) -> bool:
        """Append ``n`` pages to an occupied slot's allocation (the
        optimistic admission mode's on-demand growth).  All-or-nothing:
        returns False — taking no pages — when the slot is at
        ``max_pages_per_slot`` or the free list is short; the caller
        (engine) then preempts somebody rather than decoding into pages the
        slot does not own."""
        owned = self._owned.get(slot)
        if owned is None:
            raise ValueError(f"slot {slot} holds no pages to grow")
        if len(owned) + n > self.max_pages_per_slot or n > len(self._free):
            return False
        for _ in range(n):
            page = self._free.pop()
            self._table[slot, len(owned)] = page
            owned.append(page)
        return True

    def num_owned(self, slot: int) -> int:
        return len(self._owned.get(slot, ()))

    def capacity(self, slot: int) -> int:
        """Tokens the slot's current pages can hold."""
        return self.num_owned(slot) * self.page_size

    def release(self, slot: int) -> list[int]:
        """Return ``slot``'s pages to the free list and point its table row
        at the trash page."""
        pages = self._owned.pop(slot, [])
        self._free.extend(reversed(pages))
        self._table[slot, :] = self.trash
        return pages

    # -- views --------------------------------------------------------------

    def table(self) -> np.ndarray:
        """(num_slots, max_pages_per_slot) int32 — a copy, safe to hand to
        the device."""
        return self._table.copy()

    def slot_pages(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, []))

    def check_invariants(self) -> None:
        """Every page is owned by exactly one slot or free; tables agree."""
        owned = [p for ps in self._owned.values() for p in ps]
        assert len(owned) == len(set(owned)), "page owned twice"
        assert not (set(owned) & set(self._free)), "page both owned and free"
        assert len(owned) + len(self._free) == self.num_pages, \
            "pages leaked or invented"
        assert self.trash not in owned, "trash page allocated"
        for slot in range(self.num_slots):
            row = [p for p in self._table[slot] if p != self.trash]
            assert row == self._owned.get(slot, []), \
                f"table row {slot} disagrees with ownership"
