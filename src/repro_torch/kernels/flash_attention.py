"""Attention: the CUDA kernels' wrappers and their plain twins.

* ``flash_attention_decode_paged`` is the port of the TPU kernel
  ``src/repro/kernels/flash_attention.py::flash_attention_decode_paged``
  (its ``pallas_call`` at line 523): decode over a paged KV cache,
  launching ``csrc/flash_decode_paged.cu``.
* ``flash_attention_decode`` is the port of
  ``flash_attention.py::flash_attention_decode`` (its ``pallas_call`` at
  line 322): decode over dense slot caches, launching
  ``csrc/flash_decode.cu``.
* ``flash_attention`` is the port of ``flash_attention.py::flash_attention``
  (its ``pallas_call`` at line 153): forward attention over whole
  sequences (prefill), launching ``csrc/flash_attention.cu``.

On CUDA tensors each wrapper launches its hand-written Hopper kernel
(built with nvcc for sm_90a at first use, see ``kernels/build.py``) or
raises; on CPU tensors it runs its ``*_plain`` twin, the same function in
plain PyTorch, which the CPU tests hold against the JAX kernel and
``chip_smoke.py`` holds the CUDA kernel against on the card.

The two decode kernels are bound by bytes: the live K/V they must read
once over the card's HBM bandwidth.  The forward kernel is bound by
operations at long sequences.  Each source says how its design meets its
bound and what is left for later.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..roofline import count as _count
from .build import check_launch, library, on_cpu, require
from .build import sm_count as _sm_count

NEG_INF = -1e30
F32 = torch.float32


def _masked_probs(s, valid):
    """The plain versions' softmax rule, as the kernels apply it: masked
    scores NEG_INF, masked probabilities exactly 0.  Returns the
    unnormalized probabilities and their row sums, 1 for a row with no
    valid key (which so outputs 0)."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return p, torch.where(l == 0, torch.ones_like(l), l)


def _active_pages(pos, sq, n_blocks, page, window, page_base):
    """(start position of each table entry, whether the kernel visits
    it): page-level skipping, exactly as the kernel decides it.  pos:
    (b,) int64."""
    b = pos.shape[0]
    start = (page_base.to(torch.int64) if page_base is not None else
             (torch.arange(n_blocks, device=pos.device) * page).expand(
                 b, n_blocks))
    active = start <= (pos + sq - 1)[:, None]
    if page_base is not None:
        active &= start >= 0
    if window is not None:
        active &= start + page - 1 > (pos - window)[:, None]
    return start, active


def flash_attention_decode_paged_plain(
        q, k_pages, v_pages, block_tab, pos, window: Optional[int] = None,
        page_base=None, k_scale_pages=None, v_scale_pages=None,
        scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: same inputs, same skipping,
    masking (NEG_INF), empty-row (0) and output-dtype rules, computed in
    fp32 as one masked softmax per row instead of the kernel's
    page-by-page online softmax."""
    b, hq, sq, d = q.shape
    n_pages, hkv, page, _ = k_pages.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if (k_scale_pages is None) != (v_scale_pages is None):
        raise ValueError("k/v scale pages must be passed together")
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    n_blocks = block_tab.shape[1]
    dev = q.device
    bt = block_tab.to(torch.int64).clamp(0, n_pages - 1)
    kd = k_pages[bt].to(F32)                          # (b, nb, hkv, page, d)
    vd = v_pages[bt].to(F32)
    if k_scale_pages is not None:
        kd = kd * k_scale_pages[bt].to(F32)
        vd = vd * v_scale_pages[bt].to(F32)
    S = n_blocks * page
    kd = kd.transpose(1, 2).reshape(b, hkv, S, d)
    vd = vd.transpose(1, 2).reshape(b, hkv, S, d)
    qg = q.reshape(b, hkv, group, sq, d).to(F32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kd)     # (b, hkv, g, sq, S)

    pos = pos.to(torch.int64).reshape(-1).expand(b)
    start, active = _active_pages(pos, sq, n_blocks, page, window, page_base)
    kpos = (start[:, :, None] + torch.arange(page, device=dev)).reshape(b, S)
    qpos = pos[:, None] + torch.arange(sq, device=dev)           # (b, sq)
    valid = (kpos[:, None, :] <= qpos[:, :, None]) \
        & active.repeat_interleave(page, dim=1)[:, None, :]
    if page_base is not None:
        valid &= (kpos >= 0)[:, None, :]
    if window is not None:
        valid &= kpos[:, None, :] > qpos[:, :, None] - window
    p, l = _masked_probs(s, valid[:, None, None])     # (b, 1, 1, sq, S)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vd) / l
    return o.reshape(b, hq, sq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("flash_decode_paged").flash_decode_paged
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# keys per tile of csrc/flash_decode_paged.cu (kTileKeys): whole pages,
# one page when a page holds 64 keys or more.
PAGED_TILE_KEYS = 64


def paged_tile_pages(page: int) -> int:
    return 1 if page >= PAGED_TILE_KEYS else PAGED_TILE_KEYS // page


def paged_splits(b: int, hkv: int, n_blocks: int, page: int,
                 n_sm: int) -> int:
    """How many CTAs share one (sequence, kv head): enough for two CTAs
    per SM, at most one per tile of the table.  Shapes only: the live
    range depends on ``pos``, which the host never reads (that would sync
    the device on every decode step)."""
    n_tiles = -(-n_blocks // paged_tile_pages(page))
    return max(1, min(n_tiles, -(-2 * n_sm // (b * hkv))))


_require = functools.partial(require, "flash_attention_decode_paged")


def _paged_work(q, k_pages, v_pages, block_tab, pos, window=None,
                page_base=None, k_scale_pages=None, v_scale_pages=None,
                scale=None):
    """B1's work for the roofline counter: the pages the kernel visits
    (its page-level skipping; every table entry on fake tensors, whose
    positions are unknown), each page's K and V of every kv head (and
    scales) read once."""
    b, hq, sq, d = q.shape
    n_blocks = block_tab.shape[1]
    _, hkv, page, _ = k_pages.shape
    if _count.is_fake(pos):
        pages = b * n_blocks
    else:
        _, active = _active_pages(pos.to(torch.int64).reshape(-1).expand(b),
                                  sq, n_blocks, page, window, page_base)
        pages = int(active.sum())
    row = hkv * d * (k_pages.element_size() + v_pages.element_size())
    if k_scale_pages is not None:
        row += hkv * (k_scale_pages.element_size()
                      + v_scale_pages.element_size())
    flops, nbytes = _count.decode_attention_work(q, pages * page, row)
    return flops, nbytes + block_tab.numel() * block_tab.element_size()


@_count.by_formula(_paged_work)
def flash_attention_decode_paged(
        q, k_pages, v_pages, block_tab, pos, window: Optional[int] = None,
        page_base=None, k_scale_pages=None, v_scale_pages=None,
        scale: Optional[float] = None):
    """Decode attention over a *paged* KV cache.

    q: (b, hq, sq, d) — sq == 1 is the plain decode step, sq > 1 a verify
    span whose rows sit at pos..pos+sq-1, each with its own causal band;
    k_pages/v_pages: (n_pages, hkv, page, d) shared pools; block_tab:
    (b, n_blocks) int32 physical page per logical page (entries outside
    [0, n_pages) are clamped — they are skipped or masked); pos: (b,)
    int32 position of the first query row.  ``window`` applies the
    per-row (qpos - window, qpos] band; ``page_base`` (b, n_blocks) int32
    gives ring-of-pages base positions (negative = never written);
    ``k_scale_pages``/``v_scale_pages`` (n_pages, hkv, page, 1) bf16
    dequantize int8 pools.  Returns (b, hq, sq, d) in q's dtype.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (q f32 or bf16; pools bf16, or int8 with bf16 scales; all contiguous,
    int32 tables) on the current stream, or raise: ``paged_splits``
    CTAs share each (sequence, kv head), and a second kernel combines
    their partials.  Each launch adds one to
    ``flash_attention_decode_paged.launches``.
    """
    tensors = [t for t in (q, k_pages, v_pages, block_tab, pos, page_base,
                           k_scale_pages, v_scale_pages) if t is not None]
    if on_cpu("flash_attention_decode_paged", *tensors):
        return flash_attention_decode_paged_plain(
            q, k_pages, v_pages, block_tab, pos, window=window,
            page_base=page_base, k_scale_pages=k_scale_pages,
            v_scale_pages=v_scale_pages, scale=scale)

    _require(q.dim() == 4, f"q must be (b, hq, sq, d), got {tuple(q.shape)}")
    b, hq, sq, d = q.shape
    _require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
             "k/v pools must share a (n_pages, hkv, page, d) shape")
    n_pages, hkv, page, dk = k_pages.shape
    _require(dk == d, f"head dim {dk} of the pools != q's {d}")
    _require(hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q dtype {q.dtype} (kernel takes float32 or bfloat16)")
    quantized = k_scale_pages is not None
    _require((v_scale_pages is not None) == quantized,
             "k/v scale pages must be passed together")
    if quantized:
        _require(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8,
                 "scale pages need int8 pools")
        for sc in (k_scale_pages, v_scale_pages):
            _require(sc.dtype == torch.bfloat16
                     and tuple(sc.shape) == (n_pages, hkv, page, 1)
                     and sc.is_contiguous(),
                     "scale pages must be contiguous bf16 (n_pages, hkv, "
                     "page, 1)")
    else:
        _require(k_pages.dtype == torch.bfloat16
                 and v_pages.dtype == torch.bfloat16,
                 f"pool dtype {k_pages.dtype} (kernel takes bf16, or int8 "
                 "with scale pages)")
    _require(block_tab.dim() == 2 and block_tab.shape[0] == b
             and block_tab.dtype == torch.int32, "block_tab must be (b, "
             "n_blocks) int32")
    n_blocks = block_tab.shape[1]
    _require(pos.dtype == torch.int32 and tuple(pos.shape) == (b,),
             "pos must be (b,) int32")
    if page_base is not None:
        _require(page_base.dtype == torch.int32
                 and tuple(page_base.shape) == (b, n_blocks)
                 and page_base.is_contiguous(),
                 "page_base must be contiguous (b, n_blocks) int32")
    _require(window is None or int(window) > 0, "window must be positive")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tab", block_tab), ("pos", pos)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    vec = 16 // k_pages.element_size()     # the kernel loads 16-byte vectors
    _require(d % vec == 0, f"head dim {d} must be a multiple of {vec}")
    _require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
             "pools must be 16-byte aligned")

    fn = _kernel()
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    out = torch.empty_like(q)
    n_split = paged_splits(b, hkv, n_blocks, page, _sm_count(q.device.index))
    part_acc = part_ml = None
    if n_split > 1:     # per-split (acc) and (m, l), combined on the card
        rows = sq * (hq // hkv)
        part_acc = torch.empty((b, hkv, n_split, rows, d), dtype=F32,
                               device=q.device)
        part_ml = torch.empty((b, hkv, n_split, rows, 2), dtype=F32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale_pages.data_ptr() if quantized else None,
             v_scale_pages.data_ptr() if quantized else None,
             block_tab.data_ptr(), pos.data_ptr(),
             page_base.data_ptr() if page_base is not None else None,
             out.data_ptr(),
             part_acc.data_ptr() if part_acc is not None else None,
             part_ml.data_ptr() if part_ml is not None else None,
             b, hq, hkv, sq, d, n_pages, page, n_blocks, n_split,
             int(window) if window is not None else 0, float(scale),
             int(q.dtype == torch.bfloat16), int(quantized), stream)
    check_launch("flash_attention_decode_paged", err)
    flash_attention_decode_paged.launches += 1
    return out


flash_attention_decode_paged.launches = 0


# --- dense slot caches (kernel B3) ------------------------------------------------------


def _check_decode(q, k, window, ring) -> None:
    """The reference's argument checks (``ValueError`` as it raises)."""
    sq, hq, hkv = q.shape[2], q.shape[1], k.shape[1]
    if sq != 1:
        raise ValueError(f"decode fast path requires sq == 1, got {sq}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if ring and window is None:
        raise ValueError("ring layout requires a window size")


def flash_attention_decode_plain(q, k, v, pos, window: Optional[int] = None,
                                 ring: bool = False,
                                 scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: same validity rule (ring: all
    slots once pos >= window; else keys <= pos, inside the optional band),
    NEG_INF masking, empty-row (0) and output-dtype rules, computed in
    fp32 as one masked softmax per row instead of the kernel's tile-by-
    tile online softmax."""
    _check_decode(q, k, window, ring)
    b, hq, _, d = q.shape
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64).reshape(
        -1).expand(b)
    _, hkv, S, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, group, d).to(F32) * scale
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.to(F32))   # (b, hkv, g, S)
    kpos = torch.arange(S, device=q.device)[None, :]
    p = pos[:, None]
    if ring:
        valid = (kpos <= p) | (p >= window)
    else:
        valid = kpos <= p
        if window is not None:
            valid &= kpos > p - window
    e, l = _masked_probs(s, valid[:, None, None, :])      # (b, 1, 1, S)
    o = torch.einsum("bhgk,bhkd->bhgd", e, v.to(F32)) / l
    return o.reshape(b, hq, 1, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _dense_kernel():
    fn = library("flash_decode").flash_decode
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# keys per tile of csrc/flash_decode.cu (kTileKeys)
DENSE_TILE_KEYS = 64


def dense_splits(b: int, hkv: int, S: int, n_sm: int) -> int:
    """How many CTAs share one (slot, kv head): enough for two CTAs per
    SM, at most one per 64-key tile of the cache.  Shapes only: the live
    range depends on ``pos``, which the host never reads."""
    n_tiles = -(-S // DENSE_TILE_KEYS)
    return max(1, min(n_tiles, -(-2 * n_sm // (b * hkv))))


def _dense_work(q, k, v, pos, window=None, ring=False, scale=None):
    """B3's work for the roofline counter: each row's live keys (keys <=
    pos, inside the band; the whole ring once pos >= window; every slot
    on fake tensors, whose positions are unknown), K and V of every kv
    head read once per live key."""
    b = q.shape[0]
    _, hkv, S, d = k.shape
    if not torch.is_tensor(pos):
        pos = torch.full((b,), int(pos), dtype=torch.int64)
    if _count.is_fake(pos):
        keys = b * S
    else:
        live = (pos.to(torch.int64).reshape(-1).expand(b) + 1).clamp(max=S)
        if window is not None:
            live = live.clamp(max=int(window))
        keys = int(live.sum())
    row = hkv * d * (k.element_size() + v.element_size())
    return _count.decode_attention_work(q, keys, row)


@_count.by_formula(_dense_work)
def flash_attention_decode(q, k, v, pos, window: Optional[int] = None,
                           ring: bool = False, scale: Optional[float] = None):
    """Single-step (sq == 1) decode attention over dense slot caches.

    q: (b, hq, 1, d); k, v: (b, hkv, S, d); pos: (b,) int32, the position
    each sequence decodes (cache entries <= pos are live).  ``ring=True``:
    k/v are the rolled sliding-window cache (slot = position % window,
    S == window), every slot valid once pos >= window.  ``ring=False`` with
    ``window`` applies the (pos - window, pos] band.  Returns (b, hq, 1, d)
    in q's dtype.

    CPU tensors run the plain version.  CUDA tensors launch the kernel (q,
    k, v all float32 or all bfloat16, contiguous; pos (b,) int32) on the
    current stream, or raise: ``dense_splits`` CTAs share each (slot, kv
    head), and a second kernel combines their partials.  Each call adds
    one to ``flash_attention_decode.launches``."""
    tensors = [q, k, v] + ([pos] if torch.is_tensor(pos) else [])
    if on_cpu("flash_attention_decode", *tensors):
        return flash_attention_decode_plain(q, k, v, pos, window=window,
                                            ring=ring, scale=scale)
    req = functools.partial(require, "flash_attention_decode")
    req(q.dim() == 4, f"q must be (b, hq, 1, d), got {tuple(q.shape)}")
    _check_decode(q, k, window, ring)
    b, hq, _, d = q.shape
    req(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
        and k.shape[3] == d, "k/v must share a (b, hkv, S, d) shape")
    hkv, S = k.shape[1], k.shape[2]
    req(q.dtype in (torch.float32, torch.bfloat16)
        and k.dtype == q.dtype and v.dtype == q.dtype,
        f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} (kernel takes all "
        "float32 or all bfloat16)")
    req(torch.is_tensor(pos) and pos.dtype == torch.int32
        and tuple(pos.shape) == (b,) and pos.is_contiguous(),
        "pos must be a contiguous (b,) int32 tensor")
    req(window is None or int(window) > 0, "window must be positive")
    for name, t in (("q", q), ("k", k), ("v", v)):
        req(t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{name} must be contiguous and 16-byte aligned")
    req(d % (16 // q.element_size()) == 0,
        f"head dim {d} must fill whole 16-byte vectors")

    fn = _dense_kernel()
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    out = torch.empty_like(q)
    n_split = dense_splits(b, hkv, S, _sm_count(q.device.index))
    part_acc = part_ml = None
    if n_split > 1:     # per-split (acc) and (m, l), combined on the card
        group = hq // hkv
        part_acc = torch.empty((b, hkv, n_split, group, d), dtype=F32,
                               device=q.device)
        part_ml = torch.empty((b, hkv, n_split, group, 2), dtype=F32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
             out.data_ptr(),
             part_acc.data_ptr() if part_acc is not None else None,
             part_ml.data_ptr() if part_ml is not None else None,
             b, hq, hkv, S, d, n_split,
             int(window) if window is not None else 0, int(ring),
             float(scale), int(q.dtype == torch.bfloat16), stream)
    check_launch("flash_attention_decode", err)
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0


# --- forward (prefill) attention (kernel B5) --------------------------------------------

# head dims the kernel is instantiated for, in both dtypes
# (csrc/flash_attention.cu): bf16 runs on the tensor cores with a q tile
# and two stages of K/V tiles in bf16 (99-104 KB), fp32 on the CUDA cores
# with fp32 q and K/V tiles, which at d = 256 take 210 KB, the most one
# CTA may have.
FLASH_HEAD_DIMS = (32, 64, 128, 192, 256)


def flash_attention_plain(q, k, v, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: same mask (queries aligned to
    the end of the keys, causal, optional window), NEG_INF masking,
    empty-row (0) and output-dtype rules, computed in fp32 as one masked
    softmax per row instead of the kernel's tile-by-tile online softmax."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, group, sq, d).to(F32) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(F32))
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    p, l = _masked_probs(s, valid)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(F32)) / l
    return o.reshape(b, hq, sq, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _flash_kernel():
    fn = library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """Forward tiled online-softmax attention.

    q: (b, hq, sq, d); k, v: (b, hkv, sk, d) with hq % hkv == 0 (query
    head h reads kv head h // group).  Queries align to the end of the
    keys (query row i sits at position i + sk - sq); ``causal`` keeps keys
    at or before it, ``window`` those after position - window.  A row
    with no valid key outputs 0.  Returns (b, hq, sq, d) in q's dtype.

    CPU tensors run the plain version.  CUDA tensors (q, k, v all float32
    or all bfloat16, contiguous, d in ``FLASH_HEAD_DIMS``) launch the
    kernel on the current stream, or raise.  Each launch adds one to
    ``flash_attention.launches``."""
    if on_cpu("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    req = functools.partial(require, "flash_attention")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
        "q must be (b, hq, sq, d) and k, v one (b, hkv, sk, d) shape")
    b, hq, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    req(k.shape[0] == b and dk == d, f"k/v shape {tuple(k.shape)} does not "
        f"match q's {tuple(q.shape)}")
    req(hq % hkv == 0, f"q heads {hq} not a multiple of kv heads {hkv}")
    req(d in FLASH_HEAD_DIMS, f"head dim {d} (kernel takes "
        f"{FLASH_HEAD_DIMS}; beyond 256 its tiles exceed shared memory)")
    req(q.dtype in (torch.float32, torch.bfloat16)
        and k.dtype == q.dtype and v.dtype == q.dtype,
        f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} (kernel takes all "
        "float32 or all bfloat16)")
    req(window is None or int(window) > 0, "window must be positive")
    for name, t in (("q", q), ("k", k), ("v", v)):
        req(t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{name} must be contiguous and 16-byte aligned")
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _flash_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, hq, hkv, sq, sk, d, int(causal),
                          int(window) if window is not None else 0,
                          float(scale), int(q.dtype == torch.bfloat16),
                          stream)
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
