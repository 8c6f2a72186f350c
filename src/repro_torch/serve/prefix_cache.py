"""Refcounted page allocation (port of ``serve/prefix_cache.py``).

``PageAllocator`` is the host-side free list of a device page pool,
refcounted so that a later slice can share pages between sequences.
The radix-tree ``PrefixIndex`` comes with the prefix-cache slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class PageAllocator:
    """Host-side refcounted free-list allocator for a device page pool.

    ``alloc(n)`` returns n physical page ids at refcount 1 or ``None``
    (insufficient — the caller backpressures; never a partial grab).
    ``incref`` adds a holder to already-allocated pages (prefix-cache
    attachment); ``free`` (alias ``decref``) drops one holder and
    recycles the page when the count reaches zero.  All three validate
    their pages — out-of-range, never-allocated, or already-freed pages
    raise ``ValueError`` instead of corrupting the free list.  O(1) per
    page; the pool itself never moves on device.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._rc: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._rc)

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one reference."""
        return sum(1 for c in self._rc.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def _check(self, p: int, op: str) -> None:
        if not 0 <= p < self.n_pages:
            raise ValueError(
                f"{op} of out-of-range page {p} (pool has {self.n_pages})")
        if p not in self._rc:
            raise ValueError(
                f"{op} of unallocated (or already freed) page {p}")

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._check(p, "incref")
            self._rc[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._check(p, "free")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._free.append(p)

    decref = free

    def check_consistency(self) -> None:
        """Full-pool invariant check (chaos tests run this after every
        recovery path): free list and refcount table partition the pool,
        no duplicates, no zero refcounts.  Raises ``AssertionError``."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        assert not free & self._rc.keys(), "page both free and allocated"
        assert all(0 <= p < self.n_pages for p in free), \
            "out-of-range page in free list"
        assert all(0 <= p < self.n_pages for p in self._rc), \
            "out-of-range page in refcount table"
        assert all(c > 0 for c in self._rc.values()), \
            "zero/negative refcount retained"
        assert len(self._free) + len(self._rc) == self.n_pages, \
            "free + allocated != pool size (leaked or duplicated pages)"
