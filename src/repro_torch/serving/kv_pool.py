"""Paged KV-cache pool: host-side page allocator + device-pool helpers
(``repro.serving.kv_pool``). The allocator ``PagedKVPool`` is a copy of the
reference's (it imports no JAX); the device helpers work in place on the
port's pools, a list with one dict per layer of {"k", "v": (P, page, Hkv,
hd), "page_pos": (P, page)} (int8 pools add "k_scale", "v_scale": (P,
page, Hkv)), where the reference returns new pytrees.

Rows of different lengths share one physical cache. The device side (built by
``Model.init_paged_cache``) is a pool of ``num_pages`` fixed-size pages per
attention sublayer; this module owns the *mapping*: which physical pages back
which request, exposed to the decode path as a dense page table
``(num_slots, max_pages_per_seq)`` of physical page ids.

Conventions (shared with ``models.attention.paged_decode_attention``):
  - physical page 0 is reserved as the null/trash page. Unallocated table
    entries are 0; reads through a 0 entry are force-masked, and writes from
    masked-out rows are routed there. Page 0 is never handed out.
  - a slot's pages appear in the table in logical order, so the gathered
    per-row view is position-contiguous (same layout a dense cache would
    have, which is what makes static/continuous token-equivalence exact).

Prefix sharing (serving.prefix_cache) adds per-page *reference counts* with
copy-on-write semantics:
  - a physical page may back the same logical page index of many slots
    (``alloc(..., shared=...)``), and the prefix cache itself can hold a
    reference (``fork``/``release``) so a page outlives its original owner.
  - shared pages are read-only by contract: they hold only positions strictly
    below every sharer's committed length, so decode writes, speculative
    rejected-slot invalidation, and tree commits never touch them. The one
    write that can target a shared page — resuming prefill inside the last
    shared page — goes through ``cow_page`` first (write-triggered private
    copy of the tail page, mirrored on device by ``copy_pages``).
  - ``free_slot``/``release`` only return a page to the free list when its
    refcount reaches zero, and report exactly those pages so the engine can
    invalidate them (and nothing else) in the device pools.

Admission control reserves the *worst case* (prompt + max_new + speculative
slack) up front, so a decode can never run out of pages mid-request and no
preemption/swap path is needed — the simplest policy that cannot deadlock.
``compact()`` renumbers live pages down to the lowest indices and returns the
permutation to apply to the device pools (``apply_page_permutation``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class PagedKVPool:
    """Host-side allocator for a pool of ``num_pages`` KV pages.

    One allocator serves both the draft and target pools: the two models see
    the same page ids (their device pools are sized identically in pages, so
    a single page table drives both).
    """

    num_pages: int
    page_size: int
    max_pages_per_seq: int
    _free: List[int] = field(default_factory=list)
    _owned: Dict[int, List[int]] = field(default_factory=dict)   # slot -> pages
    _ref: Dict[int, int] = field(default_factory=dict)           # page -> refs

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved null page)")
        # LIFO free list popped from the end, so a fresh pool allocates
        # ascending from page 1; page 0 reserved
        self._free = list(range(self.num_pages - 1, 0, -1))

    # ------------------------------------------------------------ queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def utilization(self) -> float:
        return self.num_allocated / max(self.num_pages - 1, 1)

    def pages_needed(self, n_tokens: int) -> int:
        return ceil_div(max(n_tokens, 1), self.page_size)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.can_alloc_shared(n_tokens)

    def can_alloc_shared(self, n_tokens: int, n_shared: int = 0,
                         cow: bool = False) -> bool:
        """Admissibility with ``n_shared`` prefix pages mapped from the cache
        (they consume no free pages) and optionally one extra free page for
        the copy-on-write private copy of the tail shared page."""
        need = self.pages_needed(n_tokens)
        if need > self.max_pages_per_seq:
            return False
        fresh = max(need - n_shared, 0) + (1 if cow else 0)
        return fresh <= len(self._free)

    def page_ref(self, page: int) -> int:
        return self._ref.get(page, 0)

    def shared_page_fraction(self) -> float:
        """Fraction of live pages referenced more than once."""
        live = [r for r in self._ref.values() if r > 0]
        if not live:
            return 0.0
        return sum(1 for r in live if r > 1) / len(live)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, slot: int, n_tokens: int,
              shared: Sequence[int] = ()) -> List[int]:
        """Reserve pages backing positions [0, n_tokens) for ``slot``.

        ``shared`` maps existing live pages as the slot's logical prefix
        (their refcounts are incremented instead of popping the free list) —
        the prefix-cache hit path. Only the remainder draws fresh pages.
        """
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(n_tokens)
        shared = list(shared)
        if len(shared) > need:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"{need} pages the request needs")
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}")
        if need - len(shared) > len(self._free):
            raise MemoryError(f"pool exhausted: need {need - len(shared)}, "
                              f"free {len(self._free)}")
        for p in shared:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"shared page {p} is not live")
        for p in shared:
            self._ref[p] += 1
        pages = shared + [self._free.pop() for _ in range(need - len(shared))]
        for p in pages[len(shared):]:
            self._ref[p] = 1
        self._owned[slot] = pages
        return pages

    def free_slot(self, slot: int) -> List[int]:
        """Drop a slot's references; return the pages that actually became
        free (refcount hit zero) — the only ones the engine may invalidate.

        Freeing a slot that owns nothing raises — a double free would
        otherwise silently duplicate pages in the free list and hand the
        same physical page to two requests."""
        if slot not in self._owned:
            raise KeyError(f"slot {slot} owns no pages (double free?)")
        return self._release(self._owned.pop(slot))

    # ------------------------------------------------------------ fork/release
    def fork(self, pages: Iterable[int]):
        """Take an extra reference on live pages (prefix-cache retention, or
        forking one sequence's prefix into another)."""
        pages = list(pages)
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"cannot fork dead page {p}")
        for p in pages:
            self._ref[p] += 1

    def release(self, pages: Iterable[int]) -> List[int]:
        """Drop one reference per page; return the pages that became free."""
        pages = list(pages)
        for p in pages:
            if self._ref.get(p, 0) <= 0:
                raise ValueError(f"cannot release dead page {p}")
        return self._release(pages)

    def _release(self, pages: Iterable[int]) -> List[int]:
        freed = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                freed.append(p)
        return freed

    def cow_page(self, slot: int, logical_idx: int) -> Tuple[int, int]:
        """Copy-on-write: make the slot's page at ``logical_idx`` private.

        If the page is exclusively owned already, this is a no-op returning
        ``(page, page)``. Otherwise a fresh page replaces it in the slot's
        mapping (old refcount decremented) and ``(old, new)`` is returned so
        the caller can mirror the copy in the device pools (``copy_pages``).
        """
        pages = self._owned[slot]
        old = pages[logical_idx]
        if self._ref[old] == 1:
            return old, old
        if not self._free:
            raise MemoryError("pool exhausted: no free page for COW copy")
        new = self._free.pop()
        self._ref[old] -= 1
        self._ref[new] = 1
        pages[logical_idx] = new
        return old, new

    def table_row(self, slot: int) -> np.ndarray:
        """Dense (max_pages_per_seq,) row: logical page -> physical id (0 pad)."""
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        pages = self._owned.get(slot, [])
        row[:len(pages)] = pages
        return row

    # ------------------------------------------------------------ defrag
    def compact(self) -> Optional[np.ndarray]:
        """Renumber live pages to the lowest ids (null page 0 stays fixed).

        Refcount-aware: a page shared by several slots (or held by the
        prefix cache) is one *physical* page — it moves once and every
        referencing slot is remapped to the same new id. Returns ``perm``
        with ``perm[new_id] = old_id`` — i.e. the gather indices for the
        device pools (``apply_page_permutation``) — or None when already
        compact. Page tables (and any prefix-cache node ids —
        ``PrefixCache.renumber``) must be re-read afterwards.
        """
        live = sorted(p for p, r in self._ref.items() if r > 0)
        if live == list(range(1, len(live) + 1)):
            return None
        old_to_new = {old: new for new, old in enumerate(live, start=1)}
        perm = np.arange(self.num_pages, dtype=np.int32)
        perm[1:len(live) + 1] = live
        # remaining slots: the pages not live, in order (keeps perm a permutation)
        dead = [p for p in range(1, self.num_pages) if p not in old_to_new]
        perm[len(live) + 1:] = dead
        for slot, pages in self._owned.items():
            self._owned[slot] = [old_to_new[p] for p in pages]
        self._ref = {old_to_new[p]: r for p, r in self._ref.items()}
        self._free = list(range(self.num_pages - 1, len(live), -1))
        return perm

    # ------------------------------------------------------------ invariants
    def check_invariants(self, cache_refs: int = 0):
        """Assert the refcount bookkeeping is consistent (test hook).

        ``cache_refs`` is the number of pages the prefix cache holds (one
        reference each). Raises AssertionError on violation."""
        mapped = sum(len(pages) for pages in self._owned.values())
        total_refs = sum(self._ref.values())
        assert total_refs == mapped + cache_refs, \
            f"refs {total_refs} != slot mappings {mapped} + cache {cache_refs}"
        live = set(self._ref)
        free = set(self._free)
        assert 0 not in live and 0 not in free, "null page leaked"
        assert not (live & free), f"freed pages still referenced: {live & free}"
        assert len(free) == len(self._free), "duplicate pages in free list"
        assert live | free == set(range(1, self.num_pages)), \
            "pages lost or duplicated"
        for pages in self._owned.values():
            assert all(p in live for p in pages), "slot references a dead page"


def _page_ids(page_ids, device):
    """Host page ids as a device index, copied without a host sync (the
    numpy buffer is staged by the copy itself)."""
    ids = torch.from_numpy(np.asarray(page_ids, np.int64))
    return ids.to(device, non_blocking=True)


def invalidate_pages(cache, page_ids):
    """Mark the given physical pages empty (page_pos = -1) in a device pool,
    in place.

    Must be applied when pages are returned to the free list: a later owner
    trims only positions *beyond its own length*, so a stale position from a
    previous tenant that happens to be small enough would otherwise pass the
    causal mask and leak the old K/V into the new row's attention.

    With prefix sharing, apply this only to the pages ``free_slot``/
    ``release`` actually freed — a retiring request's prefix pages may still
    back other rows (or the prefix cache).
    """
    idx = _page_ids(page_ids, cache[0]["page_pos"].device)
    for layer in cache:
        layer["page_pos"].index_fill_(0, idx, -1)
    return cache


def copy_pages(cache, src_ids, dst_ids):
    """Copy whole physical pages src -> dst in a device pool, in place (all
    leaves: k/v, page_pos, and int8 k_scale/v_scale ride together). The
    device half of ``PagedKVPool.cow_page``: the private copy starts
    bit-identical to the shared page, so reads through either mapping agree
    until the new owner's first write. The sources are gathered before the
    destinations are written."""
    dev = cache[0]["page_pos"].device
    src, dst = _page_ids(src_ids, dev), _page_ids(dst_ids, dev)
    for layer in cache:
        for leaf in layer.values():
            leaf.index_copy_(0, dst, leaf.index_select(0, src))
    return cache


def apply_page_permutation(cache, perm):
    """Gather device pools to match a ``compact()`` renumbering
    (``perm[new_id] = old_id``), in place: every leaf has pages on axis 0."""
    idx = _page_ids(perm, cache[0]["page_pos"].device)
    for layer in cache:
        for leaf in layer.values():
            leaf.copy_(leaf.index_select(0, idx))
    return cache
