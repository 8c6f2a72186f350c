"""Paged-KV cache layouts (port of ``models/cache_layouts.py``, flat layout).

A ``CacheLayout`` says how one attention family's KV state maps onto
shared device page pools: its page groups (independently allocated
page-id spaces), the per-layer pool declarations, the page accounting
the batcher's allocator and lazy decode growth consult, and the
spill/restore primitives slot preemption uses to park a sequence's KV
on the host and resume it bit-identically.

This slice ports the flat layout: one ``kv`` group of {k, v} pools,
(n_layers, n_pages, hkv, page, hd) per leaf, for dense and GQA configs —
bf16, or int8 with bf16 {k_scale, v_scale} pages of (n_layers, n_pages,
hkv, page, 1) when ``cfg.kv_cache_dtype == "int8"``.  Every primitive
below walks all leaves of the group, so scale pages move with their
pages.  gemma3's local/global ring-of-pages layout and MLA's latent
pages come with later slices.

Each ``PageGroup`` declares whether its pages may be aliased across
sequences (the prefix cache): flat groups are, since a page holds a
fixed positional span.  ``copy_pages`` is the copy-on-write primitive:
a shared page is duplicated into a private one on the card before the
first write that would diverge from it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import layers as L
from .params import stack_decls as _stack_decls, tree_map


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PageGroup:
    """One independently allocated page-id space of a layout.

    ``shareable``: whether pages of this group may be referenced by
    several sequences at once (the prefix cache).  Flat groups are: a
    physical page holds the K/V of a fixed positional span, identical for
    every request sharing the prompt prefix.  (A ring-of-pages window
    group, a later slice's, is not: its pages' content depends on how far
    the ring has wrapped.)"""

    shareable = True

    def __init__(self, name: str):
        self.name = name


class CacheLayout:
    """Single flat {k, v} group (dense / GQA caches; bf16, or int8 with
    scale pages)."""

    def __init__(self, cfg, page_size: int):
        self.cfg = cfg
        self.page = int(page_size)

    # -- page groups / accounting --------------------------------------------------

    @property
    def groups(self) -> Tuple[PageGroup, ...]:
        return (PageGroup("kv"),)

    @property
    def prefix_shareable(self) -> bool:
        """True iff EVERY page group can alias pages across sequences: a
        prefix-cache hit attaches the matched prefix in every group at
        once."""
        return all(g.shareable for g in self.groups)

    def n_blocks(self, name: str, max_seq: int) -> int:
        """Block-table width of a group: pages covering ``max_seq``."""
        return _ceil_div(max_seq, self.page)

    def blocks_for(self, name: str, n_tokens: int, max_seq: int) -> int:
        """Pages a sequence holding ``n_tokens`` positions needs."""
        return min(_ceil_div(max(n_tokens, 0), self.page),
                   self.n_blocks(name, max_seq))

    # -- pool declarations -----------------------------------------------------------

    def pool_decls(self, n_pages: Dict[str, int]):
        """{group: per-layer pool decl tree, stacked over layers}."""
        return {"kv": _stack_decls(
            L.attention_paged_cache_decl(self.cfg, n_pages["kv"], self.page),
            self.cfg.n_layers)}

    def page_axis(self, name: str) -> int:
        """Index of the page axis in every pool leaf of the group."""
        return 1

    # -- spill / restore (slot preemption) ----------------------------------------------

    def gather_pages(self, pools, name: str, pages: Sequence[int]):
        """Device-side gather of the given physical pages (every layer,
        every leaf), one ``index_select`` per pool leaf."""
        ax = self.page_axis(name)

        def take(_, a):
            idx = torch.as_tensor(list(pages), dtype=torch.int64,
                                  device=a.device)
            return a.index_select(ax, idx)

        return tree_map(take, pools[name])

    def restore_pages(self, pools, name: str, data, pages: Sequence[int]):
        """Scatter page payloads into (possibly different) physical pages,
        in place; returns the pools dict.  Payload dtypes must match the
        pool exactly: a silent cast would corrupt the pages, so a
        mismatch raises."""
        ax = self.page_axis(name)
        for leaf, a in pools[name].items():
            d = data[leaf]
            if d.dtype != a.dtype:
                raise TypeError(
                    f"restore_pages({name!r}): payload dtype {d.dtype} != "
                    f"pool dtype {a.dtype} — spilled pages must round-trip "
                    f"bit-identically; refusing the silent cast")
            idx = torch.as_tensor(list(pages), dtype=torch.int64,
                                  device=a.device)
            a.index_copy_(ax, idx, d.to(a.device))
        return pools

    def spill(self, pools, name: str, pages: Sequence[int]):
        """Copy the given physical pages (every layer, scale pages
        included) to host tensors, keeping each leaf's dtype (int8 pages
        stay int8, their scales bf16)."""
        return tree_map(lambda _, a: a.cpu(),
                        self.gather_pages(pools, name, pages))

    def restore(self, pools, name: str, data, pages: Sequence[int]):
        """Scatter spilled page data back into (possibly different)
        physical pages; returns the pools dict."""
        return self.restore_pages(pools, name, data, pages)

    # -- copy-on-write ----------------------------------------------------------------

    def copy_pages(self, pools, name: str, src: Sequence[int],
                   dst: Sequence[int]):
        """Duplicate the ``src`` physical pages into ``dst`` (every layer,
        every leaf: int8 value pages and their bf16 scale pages alike), in
        place on the card: one ``index_select`` and one ``index_copy_``
        per pool leaf, no host round trip.  Returns the pools dict."""
        ax = self.page_axis(name)
        dev = next(iter(pools[name].values())).device
        si, di = (torch.as_tensor(list(p), dtype=torch.int64, device=dev)
                  for p in (src, dst))
        for a in pools[name].values():
            a.index_copy_(ax, di, a.index_select(ax, si))
        return pools


@functools.lru_cache(maxsize=64)
def get_layout(cfg, page_size: int) -> Optional[CacheLayout]:
    """The layout registry.  ``None`` = the family has no pageable cache
    in the reference either (recurrent state, and the vlm/audio stubs);
    layouts of later slices raise."""
    if cfg.family not in ("dense", "moe"):
        return None
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA latent pages come with the MLA slice")
    if cfg.local_global_pattern:
        raise NotImplementedError(
            f"{cfg.name}: the local/global ring-of-pages layout comes with "
            "a later port slice")
    return CacheLayout(cfg, page_size)
