"""Radix/prefix cache over the paged KV pool: prefill shared prefixes once
(a copy of ``repro.serving.prefix_cache``, which imports no JAX).

At production scale most chat requests open with the same system prompt /
few-shot preamble, so their KV for those positions is byte-identical (same
tokens, same positions, same params). This module keys a radix tree on token
ids at *page* granularity: node at depth d holds the page_size tokens of
logical page d and the physical page that already contains their K/V. A new
request walks the tree with its prompt, maps every matched page read-only
into its own page table (``PagedKVPool.alloc(shared=...)``), and resumes
chunked prefill at the hit boundary — the shared prefix is prefilled exactly
once, ever.

Page granularity is what makes sharing safe without per-token bookkeeping:
  - only *full prompt pages* enter the tree. Their positions are all below
    the owner's prompt length, hence below every sharer's committed length,
    so decode writes, chain-rewind ``trim_paged_cache``, and the tree-commit
    rejected-slot invalidation structurally never touch a shared page (they
    only address storage positions >= the row's committed length).
  - the single exception is a full-prompt hit on a page-aligned prompt: the
    engine must re-prefill the final prompt token (its logits seed the first
    sample), and that write lands inside the last shared page. The pool's
    ``cow_page`` makes a private copy first (write-triggered COW of the tail
    page); the write then overwrites bit-identical values in the copy.

Ownership: the cache holds one pool reference per node (``fork`` on insert,
``release`` on evict), so cached prefixes survive their donor request.
Eviction is LRU-by-leaf on the radix tree: only leaves are evictable (an
interior node is an ancestor of a more recently usable prefix), the victim
is the least recently matched leaf, and pages still mapped by running rows
merely lose the cache reference (freed only at refcount zero). The engine
invalidates exactly the pages an eviction actually freed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.metrics import PrefixCacheTelemetry
from .kv_pool import PagedKVPool


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_access")

    def __init__(self, key, page, parent):
        self.key = key                    # tuple of page_size token ids
        self.page = page                  # physical page id in the pool
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.last_access = 0


class PrefixCache:
    """Token-keyed radix tree mapping prompt prefixes to pool pages."""

    def __init__(self, pool: PagedKVPool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self.root = _Node(None, 0, None)
        self._clock = 0
        self.num_nodes = 0
        self.tel = PrefixCacheTelemetry()

    # ------------------------------------------------------------- helpers
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _page_keys(self, tokens) -> List[tuple]:
        toks = np.asarray(tokens)
        P = self.page_size
        return [tuple(int(t) for t in toks[j * P:(j + 1) * P])
                for j in range(len(toks) // P)]

    # ------------------------------------------------------------- lookup
    def match(self, tokens) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens`` in full pages.

        Returns (hit_tokens, page_ids); refreshes the matched path's LRU
        stamp. The caller clamps hit_tokens to len(tokens) - 1 so the final
        prompt token is always re-prefilled (its logits are needed)."""
        t = self._tick()
        node, pages = self.root, []
        for key in self._page_keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_access = t
            pages.append(child.page)
            node = child
        return len(pages) * self.page_size, pages

    # ------------------------------------------------------------- insert
    def insert(self, tokens, pages: Sequence[int]):
        """Register a prefilled prompt's full pages. Existing nodes win (a
        concurrent prefill of the same prefix keeps the first copy; the
        duplicate stays private to its row and dies with it); new nodes take
        a cache reference on their page via ``pool.fork``."""
        t = self._tick()
        node = self.root
        for j, key in enumerate(self._page_keys(tokens)):
            if j >= len(pages):
                break
            child = node.children.get(key)
            if child is None:
                page = int(pages[j])
                self.pool.fork([page])
                child = _Node(key, page, node)
                node.children[key] = child
                self.num_nodes += 1
                self.tel.pages_inserted += 1
            child.last_access = t
            node = child

    # ------------------------------------------------------------- eviction
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict_lru_leaf(self, protect: Sequence[int] = ()
                       ) -> Optional[List[int]]:
        """Evict the least-recently-matched leaf (LRU-by-leaf policy).

        ``protect`` lists pages that must not lose their cache reference —
        the engine passes a request's just-matched pages so an admission
        cannot free the very pages it is about to map. Returns the pages
        that actually became free (possibly empty — still mapped by running
        rows), or None when nothing is evictable."""
        protect = set(protect)
        leaves = [n for n in self._leaves() if n.page not in protect]
        if not leaves:
            return None
        victim = min(leaves, key=lambda n: n.last_access)
        del victim.parent.children[victim.key]
        self.num_nodes -= 1
        self.tel.evictions += 1
        return self.pool.release([victim.page])

    # ------------------------------------------------------------- misc
    def renumber(self, old_to_new: Dict[int, int]):
        """Remap node page ids after ``PagedKVPool.compact``."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            n.page = old_to_new.get(n.page, n.page)
            stack.extend(n.children.values())

    def cached_prefixes(self) -> List[List[int]]:
        """All root-to-leaf token paths (debug/test oracle support)."""
        out = []

        def walk(node, toks):
            if not node.children:
                out.append(toks)
                return
            for key, child in node.children.items():
                walk(child, toks + list(key))

        for key, child in self.root.children.items():
            walk(child, list(key))
        return out
