"""Paged KV cache: a block allocator over one shared pool of token pages,
PyTorch port.

Copy of ``deepspeed_tpu/serving/paged_kv.py``.  The physical cache is
``[L, num_pages, Hkv, page_tokens, Dh]`` (one pool shared by every slot);
each slot owns an ordered list of pages recorded in a ``[num_slots,
slot_pages]`` int32 page table: logical token ``t`` of a slot lives at row
``t % page_tokens`` of physical page ``page_table[slot, t // page_tokens]``.

Physical page 0 is the junk page: never allocated, and a released slot's
table rows all point at it, so a parked row's junk K/V writes land where no
live slot reads.  Pages carry refcounts (a prefix-cache page may sit in
several slots' tables, shared read-only) and cache pins (a page the prefix
cache holds stays off the free list at refcount 0 until evicted).
Allocation is host bookkeeping only; the engine owns the device tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import pow2_bucket
from deepspeed_tpu_torch.models.decoding import DECODE_BLOCK, quantized_planes


def default_page_tokens(max_out_tokens: int) -> int:
    """Page granularity when the config leaves it 0: the flash-decode block,
    capped at the smallest power of two covering the per-slot budget."""
    return min(DECODE_BLOCK, pow2_bucket(max_out_tokens, lo=8))


def init_paged_kv_cache(cfg, num_pages: int, page_tokens: int,
                        dtype=torch.bfloat16, *, device: torch.device,
                        quantized: bool = False) -> Dict[str, Any]:
    """Zeroed K/V page pools on ``device``; ``quantized`` makes the int8
    pools with their fp32 scale planes ``[L, num_pages, Hkv, page, 1]`` and
    the ``x_dtype`` anchor."""
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (L, num_pages, Hkv, page_tokens, Dh)
    if quantized:
        return quantized_planes(shape, dtype, device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class PagedKVPool:
    """Host-side free-list allocator for the page pool.

    ``max_out_tokens`` is the per-slot logical budget, rounded up to a page
    multiple for the table depth (``cache_len``); ``pool_tokens`` is the
    total capacity (0 = ``num_slots * cache_len``), never below one slot's
    full budget so a lone request cannot deadlock.
    """

    def __init__(self, num_slots: int, max_out_tokens: int, *,
                 page_tokens: int = 0, pool_tokens: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.page = int(page_tokens) or default_page_tokens(max_out_tokens)
        self.slot_pages = -(-int(max_out_tokens) // self.page)
        self.cache_len = self.slot_pages * self.page
        want = int(pool_tokens) or num_slots * self.cache_len
        usable = max(self.slot_pages, -(-want // self.page))
        self.num_pages = usable + 1          # + the reserved junk page 0
        self.num_slots = num_slots
        self.page_table = np.zeros((num_slots, self.slot_pages), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._ref = np.zeros(self.num_pages, np.int32)
        self._cached: set = set()
        # LIFO free list: released pages are reused first
        self._free: List[int] = list(range(usable, 0, -1))

    # -- allocation ----------------------------------------------------
    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow the slot's table to cover ``tokens`` logical tokens; False
        when the pool is exhausted (pages already granted stay)."""
        if tokens > self.cache_len:
            raise ValueError(f"slot needs {tokens} tokens > per-slot budget "
                             f"{self.cache_len}")
        owned = self._owned[slot]
        need = -(-int(tokens) // self.page)
        while len(owned) < need:
            if not self._free:
                return False
            p = self._free.pop()
            self.page_table[slot, len(owned)] = p
            owned.append(p)
            self._ref[p] += 1
        return True

    def append_shared(self, slot: int, page: int) -> None:
        """Append one already-populated page to the slot's table, shared
        read-only (INCREF'd)."""
        if page == 0:
            raise ValueError("cannot adopt the junk page")
        owned = self._owned[slot]
        if len(owned) >= self.slot_pages:
            raise ValueError(f"slot {slot} table full")
        self.page_table[slot, len(owned)] = page
        owned.append(page)
        self._ref[page] += 1

    def adopt(self, slot: int, pages: List[int]) -> None:
        """Pre-populate a freshly-admitted (empty) slot's table with pages
        another request already computed."""
        if self._owned[slot]:
            raise ValueError(f"adopt into non-empty slot {slot}: "
                             f"{self._owned[slot]}")
        for p in pages:
            self.append_shared(slot, p)

    def release(self, slot: int) -> int:
        """DECREF every page the slot references and park its table rows on
        the junk page; returns the pages returned to the free list."""
        owned = self._owned[slot]
        freed = 0
        for p in owned:
            self._ref[p] -= 1
            if self._ref[p] == 0 and p not in self._cached:
                self._free.append(p)
                freed += 1
        owned.clear()
        self.page_table[slot, :] = 0
        return freed

    # -- prefix-cache pins ---------------------------------------------
    def pin(self, page: int) -> None:
        if page == 0:
            raise ValueError("cannot pin the junk page")
        self._cached.add(page)

    def unpin(self, page: int) -> None:
        self._cached.discard(page)
        if self._ref[page] == 0:
            self._free.append(page)

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    # -- accounting ----------------------------------------------------
    @property
    def pages_used(self) -> int:
        return int((self._ref > 0).sum())

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        return len(self._cached)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def check_no_leak(self) -> None:
        """Invariant probe: every non-junk page is accounted for exactly once
        across {slot-referenced, cache-pinned, free}."""
        counts: Dict[int, int] = {}
        for o in self._owned:
            if len(o) != len(set(o)):
                raise AssertionError(f"slot owns a page twice: {o}")
            for p in o:
                counts[p] = counts.get(p, 0) + 1
        if 0 in counts or 0 in self._free or 0 in self._cached:
            raise AssertionError("junk page allocated")
        for p in range(1, self.num_pages):
            if self._ref[p] != counts.get(p, 0):
                raise AssertionError(f"page {p}: refcount {self._ref[p]} != "
                                     f"{counts.get(p, 0)} owning slot(s)")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("page on the free list twice")
        live = set(counts) | self._cached
        if free & live:
            raise AssertionError(f"live pages on the free list: {free & live}")
        if sorted(free | live) != list(range(1, self.num_pages)):
            raise AssertionError(
                f"leaked pages: referenced={sorted(counts)} "
                f"cached={sorted(self._cached)} free={sorted(free)}")
