"""Transformer layers, dense subset (port of ``models/layers.py``).

Plain functions on tensors: ``*_decls`` builds the declarative parameter
tree (``models/params.py``), ``*_apply`` consumes the concrete dict.
Stacked leading dims (one per layer) are threaded via ``stack``, as in
the JAX package, so both packages' trees line up leaf for leaf.

Caches update in place where the JAX package returns a new array from a
donated one (its jitted serve steps donate their caches and pools): the
dense cache and the page pools passed in are the ones written.

int8 KV caches (``cfg.kv_cache_dtype == "int8"``) quantize through
``kernels.kv_quant`` (kernel B2), one bf16 scale per (head, position)
row, in the dense cache and in the page pools alike.

Paged attention also scores speculative-decode verify spans
(``attention_apply_paged(verify=True)``) and reads gemma3's local layers
through a ring of pages (``ring=True``, bases from ``ring_page_base``).
Not in this slice: MLA attention (the MLA slice), MoE (the MoE slice).
Their parameter declarations are here, so every architecture's parameter
tree can be built.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.kv_quant import (kv_dequantize, kv_quantize,
                                kv_quantize_store, kv_store_rows)
from .params import Decl

F32 = torch.float32


# --- primitives -----------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.to(F32))).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., s, h, d) or (..., s, d); pos: (s,) or (b, s).  Rotates
    the two halves of the head dim (not interleaved pairs)."""
    return _rotate(x, *_rope_angles(pos, x.shape[-1], theta, x.device))


def _rope_angles(pos, d: int, theta: float, device):
    """(cos, sin) of the rotary angles; q and k of a layer share them."""
    half = d // 2
    # a host scalar base (no tensor from a Python number: on CUDA that
    # would be a blocking copy inside every layer).
    freqs = float(theta) ** (-torch.arange(half, dtype=F32, device=device)
                             / half)
    ang = pos[..., None].to(F32) * freqs              # (..., s, half)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    if x.dim() - cos.dim() == 2:                      # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(F32)).to(gate.dtype) * up


# --- attention ------------------------------------------------------------------


def attention_xla(q, k, v, causal=True, window=None, scale=None):
    """Forward attention: the reference's blocked online-softmax XLA path
    as one plain masked softmax (equal up to rounding).

    q: (b, hq, sq, d); k: (b, hkv, sk, d); v: (b, hkv, sk, dv).  Query i
    sits at position ``sk - sq + i``."""
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d).to(F32) * scale
    s = torch.einsum("bhgqd,bhcd->bhgqc", qg, k.to(F32))
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqc,bhcv->bhgqv", p, v.to(F32))
    return o.reshape(b, hq, sq, dv).to(q.dtype)


def attention_decode(q, k, v, kv_valid, scale: Optional[float] = None):
    """Single-step decode attention over a cache.

    q: (b, hq, 1, d); k: (b, hkv, S, d); v: (b, hkv, S, dv);
    kv_valid: (b, S) bool or (S,) — which cache slots hold real keys.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d).to(F32) * scale
    s = torch.einsum("bhgqd,bhcd->bhgqc", qg, k.to(F32))
    if kv_valid.dim() == 1:
        mask = kv_valid[None, None, None, None, :]
    else:
        mask = kv_valid[:, None, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqc,bhcv->bhgqv", p, v.to(F32))
    return o.reshape(b, hq, sq, -1).to(q.dtype)


def attention_masked(q, k, v, mask, scale: Optional[float] = None):
    """Multi-query attention over a cache with an explicit per-row mask.

    q: (b, hq, sq, d); k, v: (b, hkv, S, dv); mask: (b, sq, S) bool.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d).to(F32) * scale
    s = torch.einsum("bhgqd,bhcd->bhgqc", qg, k.to(F32))
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqc,bhcv->bhgqv", p, v.to(F32))
    return o.reshape(b, hq, sq, -1).to(q.dtype)


# --- GQA attention block -----------------------------------------------------------


def attention_decls(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, Decl]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ax = ("stack",) * len(stack)
    decls = {
        "norm": Decl(stack + (d,), ax + ("embed",), init="zeros"),
        "wo": Decl(stack + (hq * hd, d), ax + ("heads", "embed")),
    }
    if cfg.fuse_qkv and hq == hkv:
        decls["wqkv"] = Decl(stack + (d, 3 * hq * hd), ax + ("embed", "heads"))
        if cfg.qkv_bias:
            decls["bqkv"] = Decl(stack + (3 * hq * hd,), ax + ("heads",),
                                 init="zeros")
    else:
        decls["wq"] = Decl(stack + (d, hq * hd), ax + ("embed", "heads"))
        decls["wk"] = Decl(stack + (d, hkv * hd), ax + ("embed", "kv_heads"))
        decls["wv"] = Decl(stack + (d, hkv * hd), ax + ("embed", "kv_heads"))
        if cfg.qkv_bias:
            decls["bq"] = Decl(stack + (hq * hd,), ax + ("heads",), init="zeros")
            decls["bk"] = Decl(stack + (hkv * hd,), ax + ("kv_heads",),
                               init="zeros")
            decls["bv"] = Decl(stack + (hkv * hd,), ax + ("kv_heads",),
                               init="zeros")
    if cfg.qk_norm:
        decls["q_norm"] = Decl(stack + (hd,), ax + (None,), init="zeros")
        decls["k_norm"] = Decl(stack + (hd,), ax + (None,), init="zeros")
    return decls


def _qkv(cfg, p, x):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if "wqkv" in p:
        qkv = x @ p["wqkv"]
        if "bqkv" in p:
            qkv = qkv + p["bqkv"]
        q, k, v = torch.chunk(qkv, 3, dim=-1)
    else:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def attention_apply(cfg, p, x, *, window: Optional[int] = None,
                    theta: Optional[float] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    pos=None, store_rows: Optional[torch.Tensor] = None):
    """Pre-norm attention with residual.  Train/prefill when cache is
    None; single-token decode otherwise: ``cache`` holds k, v of shape
    (b, hkv, S, hd) (int8 caches also k_scale, v_scale of (b, hkv, S,
    1)), written in place, and ``pos`` is a (b,) tensor (or a host int
    for every row) — each row decodes at its own position, as the
    reference's vmap over slots does.  A cache of exactly ``window``
    slots is the rolling ring buffer.  An int8 cache is written through
    ``kv_quantize_store`` at ``store_rows`` (``dense_store_rows``; the
    same for every layer, so callers may compute it once per step).  With
    ``cfg.decode_flash`` the read goes through
    ``kernels.flash_attention.flash_attention_decode``.  Returns (y,
    cache)."""
    theta = theta if theta is not None else cfg.rope_theta
    b, s, d = x.shape
    h = rmsnorm(x, p["norm"])
    q, k, v = _qkv(cfg, p, h)
    if cache is None:
        cs = _rope_angles(torch.arange(s, device=x.device), cfg.head_dim,
                          theta, x.device)
        q, k = _rotate(q, *cs), _rotate(k, *cs)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        o = attention_xla(q, k, v, causal=True, window=window)
        new_cache = None
    else:
        pos = decode_pos(pos, b, x.device)
        cs = _rope_angles(pos[:, None, None], cfg.head_dim, theta, x.device)
        q = _rotate(q, *cs).transpose(1, 2)          # (b, hq, 1, hd)
        k = _rotate(k, *cs).transpose(1, 2)          # (b, hkv, 1, hd)
        v = v.transpose(1, 2)
        S = cache["k"].shape[2]
        ring = window is not None and S == window
        if cfg.kv_cache_dtype == "int8":
            # quantize K and V into their slots: one launch of B2.
            if store_rows is None:
                store_rows = dense_store_rows(pos, S, k.shape[1], window)
            kv_quantize_store(
                k[:, :, 0].contiguous(), v[:, :, 0].contiguous(),
                cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                store_rows)
        else:
            slot = decode_slot(pos, S, window)
            rows = torch.arange(b, device=x.device)
            for name, t in _to_cache(cfg, {"k": k[:, :, 0], "v": v[:, :, 0]},
                                     cache["k"].dtype).items():
                cache[name][rows, :, slot] = t
        full = _from_cache(cache, q.dtype)            # (b, hkv, S, hd)
        if cfg.decode_flash:
            from ..kernels.flash_attention import flash_attention_decode
            o = flash_attention_decode(
                q.contiguous(), full["k"], full["v"],
                pos.to(torch.int32).contiguous(),
                window=window if ring else None, ring=ring)
        else:
            idx = torch.arange(S, device=x.device)[None, :]
            valid = idx <= pos[:, None]
            if ring:
                valid |= (pos >= window)[:, None]
            o = attention_decode(q, full["k"], full["v"], valid)
        new_cache = cache
    y = o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]
    return x + y, new_cache


def decode_pos(pos, b: int, device) -> torch.Tensor:
    """A decode step's positions as a (b,) int64 tensor on ``device``
    (``pos``: a (b,) tensor, or a host int for every row)."""
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(
        -1).expand(b)


def decode_slot(pos: torch.Tensor, S: int, window: Optional[int] = None
                ) -> torch.Tensor:
    """The dense cache slot each row of a decode step writes: ``pos %
    window`` on a rolling ring cache (S == window), else ``pos`` — both
    clamped to S - 1, as the reference's dynamic_update_slice clamps its
    start index."""
    ring = window is not None and S == window
    return (pos % window if ring else pos).clamp(max=S - 1)


def dense_store_rows(pos: torch.Tensor, S: int, n_heads: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """``kv_store_rows`` of a dense decode step in a (b, hkv, S, hd) cache
    leaf: batch row i, every head, at ``decode_slot``; (b, hkv) int64."""
    return kv_store_rows(torch.arange(pos.shape[0], device=pos.device),
                         decode_slot(pos, S, window), n_heads, S)


def ring_page_base(pos: torch.Tensor, page: int, n_blocks: int
                   ) -> torch.Tensor:
    """Logical base position of each ring-table slot.

    Slot j of a ring-of-pages table holds the LATEST logical page
    l ≡ j (mod n_blocks) with l <= pos // page — the page-granular
    analogue of the dense ring cache's mask-aware slot math.  Slots whose
    reconstructed page is negative (never written yet) get a negative
    base, which readers mask via kpos >= 0.  pos: (b,); returns (b,
    n_blocks) int32."""
    cur = pos.to(torch.int64)[:, None] // page                  # (b, 1)
    j = torch.arange(n_blocks, device=pos.device)[None, :]
    return ((cur - (cur - j) % n_blocks) * page).to(torch.int32)


def paged_write_index(block_tab: torch.Tensor, pos: torch.Tensor, s: int,
                      page: int, n_pages: int,
                      last_idx: Optional[torch.Tensor] = None,
                      cache_offset: Optional[torch.Tensor] = None,
                      ring: bool = False):
    """Where a chunk's K/V rows land in a paged pool (flat, or a ring of
    pages with ``ring``).

    Returns ``(rows_b, rows_s, page_ids, offsets)`` for the KEPT rows
    only.  The reference scatters every row and lets ``mode="drop"``
    discard the invalid page id ``n_pages``; torch indexing would raise
    (CPU) or device-assert (CUDA) instead, so rows are masked out before
    the scatter: positions past the table (flat) or pages the chunk's
    own later rows still need (ring), padded chunk tails (``last_idx``),
    read-only prefix positions (``cache_offset``) and unallocated table
    entries (ids outside ``[0, n_pages)``, e.g. the rows of inactive
    slots).  The mask is the same for every layer of a page group, so
    callers compute it once per forward."""
    keep, wp, wo = _paged_targets(block_tab, pos, s, page, n_pages,
                                  last_idx, cache_offset, ring)
    rows_b, rows_s = keep.nonzero(as_tuple=True)
    return rows_b, rows_s, wp[rows_b, rows_s], wo[rows_b, rows_s]


def paged_store_rows(block_tab: torch.Tensor, pos: torch.Tensor, s: int,
                     page: int, n_pages: int, n_heads: int,
                     last_idx: Optional[torch.Tensor] = None,
                     cache_offset: Optional[torch.Tensor] = None,
                     ring: bool = False) -> torch.Tensor:
    """``paged_write_index`` for an int8 pool: the destination row of
    every (b, s, head) K/V row in a pool leaf viewed as (-1, hd), -1 for
    the rows that are not kept, as ``kv_quantize_store`` takes them.
    Computed on the device with no host read (no ``nonzero``); the same
    for every layer of a page group."""
    keep, wp, wo = _paged_targets(block_tab, pos, s, page, n_pages,
                                  last_idx, cache_offset, ring)
    return kv_store_rows(wp, wo, n_heads, page, keep)


def _paged_targets(block_tab, pos, s, page, n_pages, last_idx,
                   cache_offset, ring=False):
    """(keep, page id, offset), each (b, s): where each chunk row lands
    and whether it is written (the masks of ``paged_write_index``)."""
    n_blocks = block_tab.shape[1]
    ar = torch.arange(s, device=block_tab.device)
    positions = pos.to(torch.int64)[:, None] + ar            # (b, s)
    logical = positions // page
    if ring:
        tab_idx = logical % n_blocks
        # only pages still live at the end of the true chunk are written:
        # an in-chunk wrap must not clobber pages the chunk's later rows
        # still need.
        end = pos.to(torch.int64) + (
            last_idx.to(torch.int64) if last_idx is not None else s - 1)
        keep = logical > (end // page)[:, None] - n_blocks
    else:
        tab_idx = logical.clamp(max=n_blocks - 1)
        keep = logical < n_blocks
    if last_idx is not None:
        keep &= ar[None, :] <= last_idx.to(torch.int64)[:, None]
    if cache_offset is not None:
        keep &= positions >= cache_offset.to(torch.int64)[:, None]
    wp = torch.gather(block_tab.to(torch.int64), 1, tab_idx)
    keep &= (wp >= 0) & (wp < n_pages)
    return keep, wp, positions % page


def attention_apply_paged(cfg, p, x, *, window: Optional[int] = None,
                          theta: Optional[float] = None,
                          pages: Dict[str, torch.Tensor],
                          block_tab: torch.Tensor, pos: torch.Tensor,
                          ring: bool = False,
                          last_idx: Optional[torch.Tensor] = None,
                          cache_offset: Optional[torch.Tensor] = None,
                          verify: bool = False, write_idx=None):
    """Pre-norm attention against a *paged* KV cache.

    x: (b, s, d) — s == 1 is a decode step, s > 1 a prefill chunk at
    positions pos..pos+s-1.  ``pages``: this layer's pools {"k", "v"} of
    shape (n_pages, hkv, page, hd), plus {"k_scale", "v_scale"} (n_pages,
    hkv, page, 1) bf16 when ``cfg.kv_cache_dtype == "int8"``, written in
    place.  ``block_tab``: (b, n_blocks) int32; entries >= n_pages are
    unallocated (writes through them are dropped, reads clamped and
    masked).  ``pos``: (b,) start position per row.  ``last_idx``/
    ``cache_offset`` mask writes as in ``paged_write_index``;
    ``write_idx`` is that function's result (for an int8 pool
    ``paged_store_rows``'s) when the caller computed it already.

    ``ring=False`` (flat layout): logical page j lives at table entry j;
    a sliding window applies the (qpos - window, qpos] band in the mask.
    ``ring=True`` (window-bounded layout, gemma3's local layers): table
    entry j holds logical page l ≡ j (mod n_blocks) and pages are reused
    in place once the table wraps, so the layer's page count stays
    O(window/page); readers reconstruct each entry's logical base
    position from ``pos`` (``ring_page_base``).

    Reads mirror the dense path's rounding exactly.  Without the kernel,
    the PRE-write pool is gathered and the chunk's own K/V overlaid: a
    prefill chunk attends its own positions at full precision, a decode
    step the pool-rounded values.  With ``cfg.decode_flash`` a decode
    step writes first and then reads through the block-table kernel
    (``kernels.flash_attention.flash_attention_decode_paged``), which
    sees the same pool-rounded values.

    ``verify=True`` (speculative decode): the s rows behave like s
    sequential decode steps scored at once — their own K/V is read
    pool-rounded (what each position would have read back through the
    cache had it been decoded one step at a time), and with
    ``cfg.decode_flash`` the span is written first and read through the
    kernel at sq == s, so accepted tokens equal plain greedy decode's.
    Returns (y, pages).
    """
    theta = theta if theta is not None else cfg.rope_theta
    b, s, d = x.shape
    h = rmsnorm(x, p["norm"])
    q, kc, vc = _qkv(cfg, p, h)                       # (b, s, h*, hd)
    positions = pos.to(torch.int64)[:, None] + torch.arange(
        s, device=x.device)                           # (b, s)
    cs = _rope_angles(positions[:, :, None], cfg.head_dim, theta, x.device)
    q = _rotate(q, *cs).transpose(1, 2)               # (b, hq, s, hd)
    kc = _rotate(kc, *cs)                             # (b, s, hkv, hd)
    pk, pv = pages["k"], pages["v"]
    n_pages, hkv, page, hd = pk.shape
    n_blocks = block_tab.shape[1]
    int8 = cfg.kv_cache_dtype == "int8"
    if write_idx is None:
        write_idx = paged_store_rows(
            block_tab, pos, s, page, n_pages, hkv, last_idx, cache_offset,
            ring) if int8 else paged_write_index(
                block_tab, pos, s, page, n_pages, last_idx, cache_offset,
                ring)

    step_like = s == 1 or verify        # own K/V read back pool-rounded
    flash = cfg.decode_flash and step_like and cache_offset is None
    if not flash:
        # gather the PRE-write pool state + overlay the chunk's own K/V.
        bt = block_tab.to(torch.int64).clamp(0, n_pages - 1)
        S = n_blocks * page

        def gather(pool):
            g = pool[bt]                              # (b, nb, hkv, page, X)
            return g.transpose(1, 2).reshape(b, hkv, S, -1)

        pre = _from_cache({n: gather(a) for n, a in pages.items()}, q.dtype)
        # a decode step (or verify span) attends its own k/v
        # pool-rounded, a chunk exactly.
        own = _from_cache(_to_cache(cfg, {"k": kc, "v": vc}, pk.dtype),
                          q.dtype) if step_like else {"k": kc, "v": vc}
        if ring:
            base = ring_page_base(pos, page, n_blocks).to(torch.int64)
            kpos = (base[:, :, None] + torch.arange(
                page, device=x.device)).reshape(b, S)
        else:
            kpos = torch.arange(S, device=x.device).expand(b, S)
        K = torch.cat([pre["k"], own["k"].transpose(1, 2)], dim=2)
        V = torch.cat([pre["v"], own["v"].transpose(1, 2)], dim=2)
        kpos_cat = torch.cat([kpos, positions], dim=1)  # (b, S + s)
        # gathered entries are only valid STRICTLY before the chunk
        # (stale or ring-relabelled entries carry kpos >= pos, entries
        # never written kpos < 0); own entries cover [pos, pos + s).
        pre_ok = torch.cat(
            [(kpos >= 0) & (kpos < positions[:, :1]),
             torch.ones((b, s), dtype=torch.bool, device=x.device)], dim=1)
        mask = (kpos_cat[:, None, :] <= positions[:, :, None]) \
            & pre_ok[:, None, :]
        if window is not None:
            mask &= kpos_cat[:, None, :] > positions[:, :, None] - window
        o = attention_masked(q, K, V, mask)

    # append: the kept rows of the chunk's K/V into the pools; int8 pools
    # quantize and store in one launch of B2.
    if int8:
        kv_quantize_store(kc.contiguous(), vc.contiguous(), pk, pv,
                          pages["k_scale"], pages["v_scale"], write_idx)
    else:
        rows_b, rows_s, wp, wo = write_idx
        for name, t in (("k", kc), ("v", vc)):
            pages[name][wp, :, wo] = t[rows_b, rows_s].to(pk.dtype)

    if flash:
        from ..kernels.flash_attention import flash_attention_decode_paged
        # the span's writes land before the read, so ring bases key off
        # the span END: entries the span wrote hold their NEW logical
        # pages (the ring's width is padded by speculate_k, so every
        # clobbered old page is out of every row's window).
        o = flash_attention_decode_paged(
            q.contiguous(), pk, pv, block_tab, pos, window=window,
            page_base=ring_page_base(pos + (s - 1), page, n_blocks)
            if ring else None,
            k_scale_pages=pages.get("k_scale"),
            v_scale_pages=pages.get("v_scale"))
    y = o.transpose(1, 2).reshape(b, s, -1) @ p["wo"]
    return x + y, pages


def _kv_leaves(cfg, shp, ax) -> Dict[str, Decl]:
    """k/v cache leaves of shape ``shp``: bf16, or int8 plus per-row bf16
    scales (``shp`` with a trailing 1) for ``kv_cache_dtype == "int8"``."""
    if cfg.kv_cache_dtype == "int8":
        sshp = shp[:-1] + (1,)
        return {"k": Decl(shp, ax, torch.int8, init="zeros"),
                "v": Decl(shp, ax, torch.int8, init="zeros"),
                "k_scale": Decl(sshp, ax, torch.bfloat16, init="zeros"),
                "v_scale": Decl(sshp, ax, torch.bfloat16, init="zeros")}
    return {"k": Decl(shp, ax, torch.bfloat16, init="zeros"),
            "v": Decl(shp, ax, torch.bfloat16, init="zeros")}


def attention_paged_cache_decl(cfg, n_pages: int, page_size: int
                               ) -> Dict[str, Decl]:
    """One attention layer's shared page pool: (n_pages, hkv, page, hd).
    The pool has no batch/slot axis — slots own *pages*, not rows.  int8
    pools also carry per-position bf16 scale pages."""
    return _kv_leaves(cfg, (n_pages, cfg.n_kv_heads, page_size,
                            cfg.head_dim), (None, "kv_heads", None, None))


def attention_cache_decl(cfg, batch: int, max_seq: int,
                         window: Optional[int] = None) -> Dict[str, Decl]:
    S = min(max_seq, window) if window else max_seq
    return _kv_leaves(cfg, (batch, cfg.n_kv_heads, S, cfg.head_dim),
                      ("batch", "kv_heads", None, None))


def _kv_quantize(t: torch.Tensor):
    """Per-(head, position) max-abs int8 quantization of (..., hd) through
    kernel B2: int8 (..., hd) and bf16 scales (..., 1)."""
    q, s = kv_quantize(t.reshape(-1, t.shape[-1]).contiguous())
    return q.reshape(t.shape), s.reshape(t.shape[:-1] + (1,))


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    """q (..., hd) int8 times scale (..., 1) -> ``dtype``, through B2."""
    out = kv_dequantize(q.reshape(-1, q.shape[-1]).contiguous(),
                        scale.reshape(-1, 1).contiguous(), dtype)
    return out.reshape(q.shape)


def _to_cache(cfg, kv: Dict[str, torch.Tensor], dtype=torch.bfloat16
              ) -> Dict[str, torch.Tensor]:
    """K/V rows {"k", "v"} of (..., hd) in the cache's storage form, the
    leaves of ``_kv_leaves``: cast to ``dtype``, or for an int8 cache
    quantized through B2, with "k_scale"/"v_scale" of (..., 1)."""
    if cfg.kv_cache_dtype != "int8":
        return {n: t.to(dtype) for n, t in kv.items()}
    qs = {n: _kv_quantize(t) for n, t in kv.items()}
    return {**{n: q for n, (q, _) in qs.items()},
            **{n + "_scale": s for n, (_, s) in qs.items()}}


def _from_cache(leaves: Dict[str, torch.Tensor], dtype
                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``_to_cache``: {"k", "v"} in ``dtype``, dequantized
    through B2 where the leaves carry scales."""
    return {n: _kv_dequantize(leaves[n], leaves[n + "_scale"], dtype)
            if n + "_scale" in leaves else leaves[n].to(dtype)
            for n in ("k", "v")}


# --- MLA (deepseek-v2): declarations only in this slice -----------------------------


def mla_decls(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, Decl]:
    d, hq = cfg.d_model, cfg.n_heads
    nope, rp, lora, vd = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                          cfg.kv_lora_rank, cfg.v_head_dim)
    ax = ("stack",) * len(stack)
    return {
        "norm": Decl(stack + (d,), ax + ("embed",), init="zeros"),
        "wq": Decl(stack + (d, hq * (nope + rp)), ax + ("embed", "heads")),
        "w_dkv": Decl(stack + (d, lora + rp), ax + ("embed", "lora")),
        "kv_norm": Decl(stack + (lora,), ax + ("lora",), init="zeros"),
        "w_uk": Decl(stack + (lora, hq * nope), ax + ("lora", "heads")),
        "w_uv": Decl(stack + (lora, hq * vd), ax + ("lora", "heads")),
        "wo": Decl(stack + (hq * vd, d), ax + ("heads", "embed")),
    }


# --- MLP / MoE ------------------------------------------------------------------------


def mlp_decls(cfg, stack: Tuple[int, ...] = (), d_ff: Optional[int] = None
              ) -> Dict[str, Decl]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    ax = ("stack",) * len(stack)
    decls = {
        "norm": Decl(stack + (d,), ax + ("embed",), init="zeros"),
        "w_up": Decl(stack + (d, f), ax + ("embed", "ff")),
        "w_down": Decl(stack + (f, d), ax + ("ff", "embed")),
    }
    if cfg.mlp_gated:
        decls["w_gate"] = Decl(stack + (d, f), ax + ("embed", "ff"))
    return decls


def mlp_apply(cfg, p, x):
    h = rmsnorm(x, p["norm"])
    if "w_gate" in p:
        hh = swiglu(h @ p["w_gate"], h @ p["w_up"])
    else:   # jax.nn.gelu's default is the tanh approximation
        hh = F.gelu((h @ p["w_up"]).to(F32), approximate="tanh").to(h.dtype)
    return x + hh @ p["w_down"]


def moe_decls(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, Decl]:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    ax = ("stack",) * len(stack)
    decls = {
        "norm": Decl(stack + (d,), ax + ("embed",), init="zeros"),
        "router": Decl(stack + (d, E), ax + ("embed", None), std=0.02),
        "w_gate": Decl(stack + (E, d, f), ax + ("experts", "embed", "ff")),
        "w_up": Decl(stack + (E, d, f), ax + ("experts", "embed", "ff")),
        "w_down": Decl(stack + (E, f, d), ax + ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        decls.update({
            "sh_gate": Decl(stack + (d, fs), ax + ("embed", "ff")),
            "sh_up": Decl(stack + (d, fs), ax + ("embed", "ff")),
            "sh_down": Decl(stack + (fs, d), ax + ("ff", "embed")),
        })
    return decls
