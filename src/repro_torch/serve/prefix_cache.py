"""Refcounted page allocation and the radix-tree prefix index (port of
``serve/prefix_cache.py``).

* ``PageAllocator`` — the host-side free list of a device page pool,
  refcounted: a physical page may be held by several slots and by the
  prefix index at once; ``alloc`` hands out pages at refcount 1,
  ``incref`` attaches another holder, and ``free``/``decref`` drops one,
  recycling the page when the last holder lets go.
* ``PrefixIndex`` — a radix tree over *blocks* of prompt tokens
  (``block`` tokens per edge, a multiple of the page size).  Retired
  prompts are inserted block by block; a later request walks the tree
  and attaches the physical pages of every matched block, so admission
  skips prefill for the matched span.  Matching is token-granular: after
  the full-block walk, the child sharing the longest common token prefix
  contributes a partially matched block (the divergence mid-page the
  batcher resolves with copy-on-write).  Cached prefixes linger until
  ``evict_lru`` reclaims them under pool pressure.

Both are host Python: the index stores page ids only, the payloads stay
on the device.  The index holds one reference per indexed page; slots
attached to a matched prefix hold their own, so evicting a prefix while
a slot reads it only drops the cache's claim.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


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


class _Node:
    """One radix-tree edge: ``block`` prompt tokens -> their pages."""

    __slots__ = ("tokens", "pages", "children", "stamp")

    def __init__(self, tokens: Tuple[int, ...],
                 pages: Dict[str, List[int]], stamp: int):
        self.tokens = tokens
        self.pages = pages                  # {group: [block//page ids]}
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = stamp


class PrefixIndex:
    """Radix tree mapping prompt-token blocks to shared physical pages.

    * ``match(prompt)`` walks full blocks by exact equality, then takes
      the longest common token prefix against the children of the last
      matched node — returning the matched token count ``m`` and, per
      page group, the physical pages covering pages
      ``0 .. ceil(m/page) - 1`` of the prompt.  The caller increfs what
      it attaches.  Matched nodes are LRU-stamped.
    * ``insert(prompt, pages)`` indexes every *full* block of a retiring
      prompt.  Blocks already present keep their existing pages (the
      caller decrefs its duplicates); new blocks absorb the caller's
      pages — the returned list of logical page indices tells the
      caller which of its references transferred to the index (same
      indices for every group).
    * ``evict_lru()`` removes the least-recently-used leaf and returns
      its full token path plus its pages for the caller to decref (a
      later slice's host tier demotes them instead) — eviction order is
      leaf-first, so a shared interior prefix outlives its divergent
      tails.
    * ``matched_blocks(prompt)`` / ``walk()`` are the queries of the
      tiered memory (a later slice): how many *full* blocks of a prompt
      the tree already holds (no LRU stamping), and an iterator over
      every node's ``(path_tokens, pages)`` for snapshot flushes.
    """

    def __init__(self, groups: Sequence[str], page: int, block: int):
        if block % page:
            raise ValueError(
                f"prefix block ({block}) must be a multiple of the page "
                f"size ({page}) so shared prefixes stay page-aligned")
        self.groups = list(groups)
        self.page = int(page)
        self.block = int(block)
        self.bpp = self.block // self.page        # pages per block
        self._root = _Node((), {g: [] for g in self.groups}, 0)
        self._clock = 0
        self.n_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def n_pages(self) -> int:
        """Pages held by the index in one group (same for every group)."""
        return self.n_nodes * self.bpp

    def match(self, prompt: np.ndarray
              ) -> Tuple[int, Dict[str, List[int]]]:
        toks = np.asarray(prompt)
        stamp = self._tick()
        out: Dict[str, List[int]] = {g: [] for g in self.groups}
        node, m = self._root, 0
        while len(toks) - m >= self.block:
            key = tuple(int(t) for t in toks[m:m + self.block])
            child = node.children.get(key)
            if child is None:
                break
            child.stamp = stamp
            for g in self.groups:
                out[g].extend(child.pages[g])
            m += self.block
            node = child
        # partial block: the child sharing the longest common token
        # prefix with the rest of the prompt (divergence mid-block).
        rest = toks[m:]
        best_t, best = 0, None
        for key, child in node.children.items():
            arr = np.asarray(key[:len(rest)])
            neq = np.nonzero(arr != rest[:len(arr)])[0]
            t = int(neq[0]) if len(neq) else len(arr)
            if t > best_t:
                best_t, best = t, child
        if best is not None:
            best.stamp = stamp
            n = _ceil_div(best_t, self.page)
            for g in self.groups:
                out[g].extend(best.pages[g][:n])
            m += best_t
        return m, out

    def insert(self, prompt: np.ndarray,
               pages: Dict[str, Sequence[int]]) -> List[int]:
        toks = np.asarray(prompt)
        stamp = self._tick()
        node, absorbed = self._root, []
        for i in range(len(toks) // self.block):
            key = tuple(int(t) for t in toks[i * self.block:
                                             (i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                taken = {g: list(pages[g][i * self.bpp:(i + 1) * self.bpp])
                         for g in self.groups}
                child = _Node(key, taken, stamp)
                node.children[key] = child
                self.n_nodes += 1
                absorbed.extend(range(i * self.bpp, (i + 1) * self.bpp))
            child.stamp = stamp
            node = child
        return absorbed

    def matched_blocks(self, prompt: np.ndarray) -> int:
        """Number of leading FULL blocks of ``prompt`` present in the
        tree (exact walk only — no partial matching, no LRU stamping).
        A host tier uses this to find the first block it may need to
        promote."""
        toks = np.asarray(prompt)
        node, b = self._root, 0
        while (b + 1) * self.block <= len(toks):
            key = tuple(int(t) for t in toks[b * self.block:
                                             (b + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                break
            node, b = child, b + 1
        return b

    def walk(self):
        """Yield ``(path_tokens, pages)`` for every node, parents before
        children — the order in which a snapshot flush demotes each node
        under its content-addressed full token path."""
        stack = [((), self._root)]
        while stack:
            path, node = stack.pop()
            for key, child in node.children.items():
                cpath = path + key
                yield cpath, child.pages
                stack.append((cpath, child))

    def evict_lru(self) -> Optional[
            Tuple[Tuple[int, ...], Dict[str, List[int]]]]:
        victim_parent, victim_key, victim = None, None, None
        victim_path: Tuple[int, ...] = ()
        stack = [((), self._root)]
        while stack:
            path, node = stack.pop()
            for key, child in node.children.items():
                if child.children:
                    stack.append((path + key, child))
                elif victim is None or child.stamp < victim.stamp:
                    victim_parent, victim_key, victim = node, key, child
                    victim_path = path + key
        if victim is None:
            return None
        del victim_parent.children[victim_key]
        self.n_nodes -= 1
        return victim_path, victim.pages
