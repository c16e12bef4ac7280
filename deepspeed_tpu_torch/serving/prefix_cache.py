"""Copy-on-write prefix caching over the paged KV pool, PyTorch port.

A copy of ``deepspeed_tpu/serving/prefix_cache.py`` without the host tier
(the ``kv_host_tier_pages`` store waits, ROADMAP.md queue 1): a
page-granular trie over prompt token ids whose nodes name physical pages,
so a new request's admission can adopt pages another request already
computed and start prefill at the match frontier.  Eviction takes the
least-recently-used LEAF whose page no live slot references, from an
intrusive LRU list over cached pages.  Host bookkeeping only; the engine
owns the device-side page copy for a partially matched boundary page.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache"]


class _Node:
    """One cached chunk: its token ids and the device page holding its KV."""

    __slots__ = ("chunk", "page", "parent", "children", "lru_prev",
                 "lru_next")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.lru_prev: Optional["_Node"] = None
        self.lru_next: Optional["_Node"] = None


class PrefixCache:
    """Page-granular trie prefix cache over a
    :class:`~deepspeed_tpu_torch.serving.paged_kv.PagedKVPool`: maps
    token-id prefixes to physical page ids and pins those pages in the pool
    so the allocator parks them instead of freeing."""

    def __init__(self, pool):
        self.pool = pool
        self.page = pool.page
        self._children: Dict[Tuple[int, ...], _Node] = {}
        self._nodes = 0
        # intrusive LRU ring: head = LRU victim, tail = MRU
        self._lru = _Node((), -2, None)
        self._lru.lru_prev = self._lru.lru_next = self._lru

    def __len__(self) -> int:
        return self._nodes

    # -- intrusive LRU list -------------------------------------------
    def _lru_remove(self, node: _Node) -> None:
        p, n = node.lru_prev, node.lru_next
        if p is not None:
            p.lru_next = n
            n.lru_prev = p
        node.lru_prev = node.lru_next = None

    def _lru_append(self, node: _Node) -> None:
        tail = self._lru.lru_prev
        tail.lru_next = node
        node.lru_prev = tail
        node.lru_next = self._lru
        self._lru.lru_prev = node

    def _lru_touch(self, node: _Node) -> None:
        self._lru_remove(node)
        self._lru_append(node)

    # ------------------------------------------------------------------
    def _walk(self, tokens: np.ndarray):
        """Yield matched nodes chunk by chunk (no touching)."""
        children = self._children
        toks = np.asarray(tokens)
        for i in range(len(toks) // self.page):
            chunk = tuple(int(t) for t in
                          toks[i * self.page:(i + 1) * self.page])
            node = children.get(chunk)
            if node is None:
                return
            yield node
            children = node.children

    def match_nodes(self, tokens: np.ndarray) -> List[_Node]:
        """Nodes of the longest cached prefix of ``tokens`` (whole pages
        only); touches the matched path (LRU)."""
        out: List[_Node] = []
        for node in self._walk(tokens):
            self._lru_touch(node)
            out.append(node)
        return out

    def match(self, tokens: np.ndarray) -> List[int]:
        """Pages of the longest cached prefix of ``tokens``."""
        return [node.page for node in self.match_nodes(tokens)]

    # ------------------------------------------------------------------
    def insert(self, tokens: np.ndarray, pages: List[int]) -> int:
        """Insert the full-page prefix of ``tokens`` backed by ``pages`` (in
        order).  Chunks already cached keep their existing page.  Returns
        how many pages were newly pinned."""
        toks = np.asarray(tokens)
        n_full = min(len(toks) // self.page, len(pages))
        children = self._children
        parent: Optional[_Node] = None
        added = 0
        for i in range(n_full):
            chunk = tuple(int(t) for t in
                          toks[i * self.page:(i + 1) * self.page])
            node = children.get(chunk)
            if node is None:
                node = _Node(chunk, int(pages[i]), parent)
                children[chunk] = node
                self.pool.pin(node.page)
                self._lru_append(node)
                self._nodes += 1
                added += 1
            else:
                self._lru_touch(node)
            parent = node
            children = node.children
        return added

    # ------------------------------------------------------------------
    def _detach(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        if siblings.get(node.chunk) is node:
            del siblings[node.chunk]

    def evict_lru(self) -> int:
        """Reclaim ONE page under pool pressure: the least-recently-used leaf
        no live slot references is unpinned and its node removed.  Returns
        pages freed (0 = nothing evictable)."""
        node = self._lru.lru_next
        victim: Optional[_Node] = None
        while node is not self._lru:
            if self.pool.ref(node.page) == 0 and not node.children:
                victim = node
                break
            node = node.lru_next
        if victim is None:
            return 0
        self._detach(victim)
        self._lru_remove(victim)
        self._nodes -= 1
        self.pool.unpin(victim.page)
        return 1

    # ------------------------------------------------------------------
    def check_no_leak(self) -> None:
        """Invariant probe: every node's page is pinned in the pool and
        linked into the LRU list exactly once; the node count adds up."""
        pages, total = [], 0
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            total += 1
            pages.append(node.page)
        if total != self._nodes:
            raise AssertionError(f"node count {total} != {self._nodes}")
        if len(set(pages)) != len(pages):
            raise AssertionError("page cached twice")
        if set(pages) != set(self.pool._cached):
            raise AssertionError(f"pins out of sync: trie={sorted(pages)} "
                                 f"pool={sorted(self.pool._cached)}")
        linked = []
        node = self._lru.lru_next
        while node is not self._lru:
            linked.append(node.page)
            node = node.lru_next
        if sorted(linked) != sorted(pages):
            raise AssertionError(f"LRU list out of sync: {sorted(linked)} vs "
                                 f"{sorted(pages)}")
