"""Host-side paged-KV plane: page allocator, prefix index, block tables
(the port's own copy of `repro/serve_lib/paged.py`; pure numpy).

Instead of one contiguous worst-case `(B, max_seq, ...)` region per
slot, attention KV lives in a pool of fixed-size pages
(`models.transformer` builds the device pools; this module owns every
host decision about them):

  PageAllocator  free list + refcounts over one pool of `n_pages`.
  PrefixIndex    a radix tree over FULL-page token chunks: admitted
                 requests reuse already-prefilled prompt pages across
                 requests, +1 refcount per cached page.
  PagedKV        the scheduler-facing state: per-slot block tables
                 (`tables` (B, slot_pages) int32, -1 = unallocated),
                 admission (lookup -> ref shared pages -> allocate the
                 private suffix), the per-step decode-frontier
                 allocation, and release on eviction.

Sharing semantics ("re-own", not copy-on-write): only FULL prompt pages
are ever shared, capped so every request prefills at least one suffix
token into freshly allocated private pages, and the page holding any
slot's write frontier is always refcount-1 private (asserted — a write
into a refcount>1 page is a correctness bug, never a fallback path).
Deallocation frees only unshared pages: eviction derefs, the page
returns to the free list only at refcount zero.

The device side reads the block tables as one int32 tensor, copied to
the device once per model call after the host has mutated them.
"""

from __future__ import annotations

import numpy as np


class PoolExhausted(RuntimeError):
    """Allocation failed even after evicting reclaimable index entries."""


class PageAllocator:
    """Free list + refcounts over a pool of `n_pages` pages.

    `alloc` hands out pages at refcount 1; `ref`/`deref` move shared
    pages up and down; a page returns to the free list exactly when its
    refcount hits zero.  Deterministic: the free list is a LIFO stack
    seeded so first allocations come out 0, 1, 2, ...
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1: {n_pages}")
        self.n_pages = n_pages
        self.refcount = np.zeros((n_pages,), np.int64)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, (p, self.refcount[p])
            self.refcount[p] = 1
        return pages

    def ref(self, pages) -> None:
        for p in pages:
            assert self.refcount[p] > 0, f"ref of dead page {p}"
            self.refcount[p] += 1

    def deref(self, pages) -> list[int]:
        """Drop one reference per page; returns the pages that freed."""
        freed = []
        for p in pages:
            assert self.refcount[p] > 0, f"deref of free page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(int(p))
                freed.append(int(p))
        return freed

    def free_pages(self) -> set[int]:
        return set(self._free)


class _Node:
    __slots__ = ("children", "page", "stamp")

    def __init__(self, page: int, stamp: int):
        self.children: dict[tuple, _Node] = {}
        self.page = page
        self.stamp = stamp


class PrefixIndex:
    """Radix tree over full-page token chunks -> physical pages.

    One node per cached page; a node holds +1 refcount on its page for
    as long as it is indexed, so live slots may evict without the
    prefix disappearing.  `evict` reclaims LRU *leaves* (deepest pages
    of the least recently touched prefix first) until the allocator can
    satisfy a request — dropping an index entry only frees HBM when no
    slot still references the page.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root: dict[tuple, _Node] = {}
        self._clock = 0

    def _chunks(self, tokens) -> list[tuple]:
        p = self.page_size
        full = len(tokens) // p
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(full)]

    def lookup(self, tokens) -> list[int]:
        """Pages for the longest indexed full-page prefix of `tokens`."""
        self._clock += 1
        pages, level = [], self.root
        for chunk in self._chunks(tokens):
            node = level.get(chunk)
            if node is None:
                break
            node.stamp = self._clock
            pages.append(node.page)
            level = node.children
        return pages

    def insert(self, tokens, pages, allocator: PageAllocator) -> int:
        """Index `tokens`' full-page chunks at `pages`; each NEW node
        takes +1 ref on its page.  Existing nodes keep their page (two
        identical prefixes prefilled independently do not re-point the
        index).  Returns the number of newly indexed pages."""
        self._clock += 1
        chunks = self._chunks(tokens)
        assert len(pages) >= len(chunks), (len(pages), len(chunks))
        added, level = 0, self.root
        for chunk, page in zip(chunks, pages, strict=False):
            node = level.get(chunk)
            if node is None:
                node = _Node(int(page), self._clock)
                allocator.ref([int(page)])
                level[chunk] = node
                added += 1
            else:
                node.stamp = self._clock
            level = node.children
        return added

    def evict(self, need_free: int, allocator: PageAllocator) -> int:
        """Drop LRU leaves until `allocator.free_count >= need_free` or
        the index is empty; returns the number of entries dropped."""
        dropped = 0
        while allocator.free_count < need_free:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            parent, key, node = leaf
            del parent[key]
            allocator.deref([node.page])
            dropped += 1
        return dropped

    def _lru_leaf(self):
        best = None

        def walk(level):
            nonlocal best
            for key, node in level.items():
                if node.children:
                    walk(node.children)
                elif best is None or node.stamp < best[2].stamp:
                    best = (level, key, node)

        walk(self.root)
        return best

    def pages(self) -> list[int]:
        out = []

        def walk(level):
            for node in level.values():
                out.append(node.page)
                walk(node.children)

        walk(self.root)
        return out

    def __len__(self) -> int:
        return len(self.pages())


class PagedKV:
    """Per-scheduler paged-KV state: block tables + allocator + index.

    `tables` (batch, slot_pages) int32 maps each slot's logical page i
    (rows [i*page, (i+1)*page)) to a physical pool page, -1 where
    unallocated; ALL attention layers share one table (page id p indexes
    every layer's own pool — the vLLM layout), so the table is a single
    host array handed to the jitted steps as a device argument.
    """

    def __init__(self, *, batch: int, max_seq: int, page_size: int,
                 n_pages: int, prefix_sharing: bool = True):
        self.page = page_size
        self.slot_pages = -(-max_seq // page_size)
        self.n_pages = n_pages
        self.alloc = PageAllocator(n_pages)
        self.tables = np.full((batch, self.slot_pages), -1, np.int32)
        self.index = PrefixIndex(page_size) if prefix_sharing else None
        self.shared_tokens = 0  # cumulative prompt tokens served from cache

    # -- allocation --------------------------------------------------------

    def _alloc(self, n: int) -> list[int]:
        if self.alloc.free_count < n and self.index is not None:
            self.index.evict(n, self.alloc)
        return self.alloc.alloc(n)  # raises PoolExhausted when still short

    def admit(self, slot: int, prompt) -> int:
        """Build slot `slot`'s block table for `prompt`; returns the
        shared-prefix length (tokens already resident — the caller
        prefills only `prompt[hist:]`).  Sharing is full-page-granular
        and capped so the suffix keeps >= 1 token: the write frontier is
        never a shared page.  Raises PoolExhausted (state untouched)
        when the private suffix cannot be allocated."""
        assert (self.tables[slot] < 0).all(), f"slot {slot} not released"
        n_tok = len(prompt)
        shared: list[int] = []
        if self.index is not None:
            matched = self.index.lookup(prompt)
            n_share = min(len(matched), (n_tok - 1) // self.page)
            shared = matched[:n_share]
        n_total = (n_tok - 1) // self.page + 1
        # Pin the shared pages BEFORE allocating: under pool pressure
        # _alloc evicts index entries, and without our reference that
        # eviction could free the pages we just matched — and even hand
        # them back out as `fresh`, aliasing the suffix onto the prefix.
        self.alloc.ref(shared)
        try:
            fresh = self._alloc(n_total - len(shared))
        except PoolExhausted:
            self.alloc.deref(shared)
            raise
        row = self.tables[slot]
        row[: len(shared)] = shared
        row[len(shared): n_total] = fresh
        # re-own semantics, asserted: every page the suffix prefill (and
        # later decode divergence) writes is freshly allocated, private.
        assert all(self.alloc.refcount[p] == 1 for p in fresh)
        hist = len(shared) * self.page
        self.shared_tokens += hist
        return hist

    def note_prefilled(self, slot: int, prompt) -> None:
        """Index `prompt`'s full pages (now resident in slot's table) so
        later admissions reuse them.  No-op without prefix sharing."""
        if self.index is None:
            return
        full = len(prompt) // self.page
        if full:
            pages = [int(p) for p in self.tables[slot, :full]]
            self.index.insert(prompt[: full * self.page], pages, self.alloc)

    def ensure_decode_page(self, slot: int, pos: int) -> None:
        """Guarantee the page holding write position `pos` exists and is
        private before a decode step writes it."""
        pi = pos // self.page
        assert pi < self.slot_pages, (pos, self.slot_pages)
        page = int(self.tables[slot, pi])
        if page < 0:
            (page,) = self._alloc(1)
            self.tables[slot, pi] = page
        if self.alloc.refcount[page] != 1:
            raise AssertionError(
                f"decode write frontier of slot {slot} (pos {pos}) is page "
                f"{page} with refcount {self.alloc.refcount[page]} — shared "
                f"pages must never be written (re-own invariant)")

    def rollback(self, slot: int, frontier_pos: int) -> None:
        """Speculative rollback: the slot's clock was
        decremented so its write frontier is `frontier_pos`; release any
        page whose rows are now entirely past the frontier.  Rolled-back
        pages were decode-frontier allocations, so they are refcount-1
        private (asserted) — a shared page can never be vacated here."""
        first_dead = frontier_pos // self.page + 1
        row = self.tables[slot]
        drop = [int(p) for p in row[first_dead:] if p >= 0]
        for p in drop:
            assert self.alloc.refcount[p] == 1, (
                f"rollback of slot {slot} would free shared page {p} "
                f"(refcount {self.alloc.refcount[p]})")
        self.alloc.deref(drop)
        row[first_dead:] = -1

    def release(self, slot: int) -> None:
        """Evicted slot: drop its references; shared pages survive in
        other slots / the index, private ones return to the free list."""
        row = self.tables[slot]
        self.alloc.deref([int(p) for p in row if p >= 0])
        row[:] = -1

    # -- invariants (the stress test drives this after every tick) ---------

    def check_invariants(self) -> None:
        """Leak/aliasing detection: refcounts equal the number of
        referencing slots (+1 per index entry), no page is both free and
        referenced, and free list + references account for exactly the
        pool."""
        expected = np.zeros((self.n_pages,), np.int64)
        for row in self.tables:
            live = [int(p) for p in row if p >= 0]
            assert len(set(live)) == len(live), f"duplicate page in {row}"
            for p in live:
                expected[p] += 1
        if self.index is not None:
            for p in self.index.pages():
                expected[p] += 1
        assert (expected == self.alloc.refcount).all(), (
            f"refcount drift: expected {expected.tolist()}, "
            f"allocator has {self.alloc.refcount.tolist()}")
        free = self.alloc.free_pages()
        assert len(free) == self.alloc.free_count, "duplicate in free list"
        referenced = {int(p) for p in np.nonzero(expected)[0]}
        assert not (free & referenced), f"pages both free and live: "\
            f"{sorted(free & referenced)}"
        assert free | referenced == set(range(self.n_pages)), (
            f"leaked pages: "
            f"{sorted(set(range(self.n_pages)) - free - referenced)}")
