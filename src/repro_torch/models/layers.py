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

``cross_attention_apply`` is musicgen's block over its conditioning
rows.

Paged attention also scores speculative-decode verify spans
(``attention_apply_paged(verify=True)``) and reads gemma3's local layers
through a ring of pages (``ring=True``, bases from ``ring_page_base``).

MLA (deepseek-v2): ``mla_apply`` for train, prefill and dense decode on
the compressed latent cache, ``mla_apply_paged`` for chunk, decode and
verify on latent pages.  MoE: ``moe_apply``, top-k routing with
capacity-bounded dispatch; ``row_capacity`` gives each batch row its own
capacity (the dense-slot steps, where the reference vmaps one row).
Neither has a hand-written kernel, in the reference or here.

Sharded serving runs the paged and MLP/MoE blocks per shard on a
shard-local config, with ``sharding.psum_parts`` after each row-split
output projection (attention and MLA ``wo``, ``w_down``, once per MoE
block) and ``gather_parts`` at MLA's latent read: the identity outside
``sharding.manual_axis``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.sharding import (constrain, gather_parts, is_dtensor,
                                    local_region, part_index, pin_grad,
                                    psum_parts, spec_for)
from ..kernels.kv_quant import (kv_dequantize, kv_quantize,
                                kv_quantize_store, kv_store_rows)
from ..roofline import count as _count
from .params import Decl

F32 = torch.float32


# --- primitives -----------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(F32)
    if is_dtensor(xf) and _split_last(xf):
        # over a split last dim: the sum of squares reduced to every rank
        # (left to itself DTensor may scatter the partial mean over the
        # sequence, and the backward then meets layouts it cannot
        # propagate).
        from torch.distributed.tensor import Partial, Replicate
        var = torch.sum(xf * xf, dim=-1, keepdim=True)
        var = var.redistribute(var.device_mesh, [
            Replicate() if isinstance(pl, Partial) else pl
            for pl in var.placements]) / xf.shape[-1]
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.to(F32))).to(x.dtype)


def _split_last(t) -> bool:
    """Whether a mesh dim splits DTensor ``t``'s last dim."""
    from torch.distributed.tensor import Shard
    return any(isinstance(pl, Shard) and pl.dim == t.dim() - 1
               for pl in t.placements)


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
    as one plain masked softmax (equal up to rounding).  The plain oracle
    of the tests and the card's checks; the model attends through
    ``attention_prefill`` / ``attention_blocked``, which never hold more
    than one tile of scores.

    q: (b, hq, sq, d); k: (b, hkv, sk, d); v: (b, hkv, sk, dv).  Query i
    sits at position ``sk - sq + i``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    return _softmax_attention(q, k, v, causal, window, scale)


def _softmax_attention(q, k, v, causal, window, scale):
    """One masked softmax over all (sq, sk) scores in fp32, normalised
    before the PV product; out in q's dtype."""
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    g = hq // hkv
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


# --- training attention: blocked online softmax with a flash-style backward -------


def _attn_pad(q, k, v, block_q: int, block_k: int):
    """Pad the sequence axes of q and k, v up to whole blocks (blocks no
    longer than the sequences)."""
    sq, sk = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    pq, pk = -sq % block_q, -sk % block_k
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pk:
        k, v = F.pad(k, (0, 0, 0, pk)), F.pad(v, (0, 0, 0, pk))
    return q, k, v, block_q, block_k


def _blk_mask(r0, rows, ki, block_k, q_off, sk, causal, window, device):
    """(rows, block_k) mask of the live (query, key) pairs of query rows
    r0 .. r0 + rows - 1 against kv block ``ki``."""
    qpos = q_off + r0 + torch.arange(rows, device=device)[:, None]
    kpos = ki * block_k + torch.arange(block_k, device=device)[None, :]
    m = kpos < sk
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def _ki_range(qi, nk, causal, window, block_q, block_k, q_off, block_skip):
    """The kv blocks query block ``qi`` visits: all of them, or with
    ``block_skip`` (causal) only the causally live, banded ones."""
    if not (block_skip and causal):
        return 0, nk
    q_lo = q_off + qi * block_q
    q_hi = q_off + (qi + 1) * block_q - 1
    lo = 0 if window is None else max(0, (q_lo - window + 1) // block_k)
    return lo, min(nk - 1, q_hi // block_k) + 1


def _qi_range(ki, nq, causal, window, block_q, block_k, q_off, block_skip):
    """The query blocks that can see kv block ``ki`` (the forward's rows;
    backward pass 2): the transpose of ``_ki_range``."""
    if not (block_skip and causal):
        return 0, nq
    qlo = max(0, (ki * block_k - q_off) // block_q)
    qhi = nq - 1
    if window is not None:
        k_hi_pos = (ki + 1) * block_k - 1
        qhi = min(nq - 1, (k_hi_pos + window - 1 - q_off) // block_q)
    return qlo, qhi + 1


def _where_finite(x, y):
    """y where x is finite, else 0."""
    return torch.where(torch.isfinite(x), y, torch.zeros((), dtype=y.dtype,
                                                         device=y.device))


def _blocked_fwd_fake(q, k, v, *args):
    b, hq, sq, _ = q.shape
    return (q.new_empty((b, hq, sq, v.shape[-1])),
            q.new_empty((b, hq, sq, 1), dtype=F32))


@_count.by_formula(_count.blocked_attention_work, fake=_blocked_fwd_fake)
def _attention_blocked_fwd(q, k, v, causal, window, scale, block_q, block_k,
                           block_skip, p_bf16):
    """Blocked online-softmax forward over ``block_q`` x ``block_k``
    tiles, fp32: the kv blocks in order, each against the rows of every
    query block that visits it (all of them, or with ``block_skip`` the
    causally live band), carrying every row's (m, l, acc).  A row meets
    its tiles in the order of the reference's loop over query blocks,
    one step holds (visiting rows, block_k) scores, and the loop takes nk
    steps, not nq x nk.  Returns (out in q's dtype, lse (b, hq, sq, 1)
    fp32).  A roofline counter counts its tiles by formula."""
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    g = hq // hkv
    q, k, v, block_q, block_k = _attn_pad(q, k, v, block_q, block_k)
    sqp, skp = q.shape[2], k.shape[2]
    nq, nk = sqp // block_q, skp // block_k
    q_off = sk - sq
    qg = q.reshape(b, hkv, g, sqp, d).to(F32) * scale
    kf, vf = k.to(F32), v.to(F32)
    m = torch.full((b, hkv, g, sqp, 1), float("-inf"), dtype=F32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sqp, 1), dtype=F32, device=q.device)
    o = torch.zeros((b, hkv, g, sqp, dv), dtype=F32, device=q.device)
    for ki in range(nk):
        lo, hi = _qi_range(ki, nq, causal, window, block_q, block_k, q_off,
                           block_skip)
        if lo >= hi:
            continue
        r0, r1 = lo * block_q, hi * block_q
        kb = kf[:, :, ki * block_k:(ki + 1) * block_k]
        vb = vf[:, :, ki * block_k:(ki + 1) * block_k]
        s = torch.einsum("bhgqd,bhcd->bhgqc", qg[:, :, :, r0:r1], kb)
        mask = _blk_mask(r0, r1 - r0, ki, block_k, q_off, sk, causal, window,
                         q.device)
        s = s.masked_fill(~mask, float("-inf"))
        m_p = m[:, :, :, r0:r1]
        m_n = torch.maximum(m_p, s.amax(-1, keepdim=True))
        m_safe = _where_finite(m_n, m_n)
        p = _where_finite(s, torch.exp(s - m_safe))
        alpha = _where_finite(m_p, torch.exp(m_p - m_safe))
        l[:, :, :, r0:r1] = l[:, :, :, r0:r1] * alpha + p.sum(-1, keepdim=True)
        if p_bf16:
            # bf16 probabilities and values into the PV product, fp32
            # accumulation (products of bf16 values are exact in fp32).
            pv = torch.einsum(
                "bhgqc,bhcv->bhgqv", p.to(torch.bfloat16).to(F32),
                vb.to(torch.bfloat16).to(F32))
        else:
            pv = torch.einsum("bhgqc,bhcv->bhgqv", p, vb)
        o[:, :, :, r0:r1] = o[:, :, :, r0:r1] * alpha + pv
        m[:, :, :, r0:r1] = m_n
    l_safe = torch.where(l == 0.0, torch.ones((), dtype=F32, device=l.device),
                         l)
    out = (o / l_safe)[:, :, :, :sq]
    lse = (_where_finite(m, m) + torch.log(l_safe))[:, :, :, :sq]
    return (out.reshape(b, hq, sq, dv).to(q.dtype),
            lse.reshape(b, hq, sq, 1))


def _blocked_bwd_fake(q, k, v, *args):
    return tuple(map(torch.empty_like, (q, k, v)))


@_count.by_formula(_count.blocked_attention_bwd_work, fake=_blocked_bwd_fake)
def _attention_blocked_bwd(q, k, v, out, lse, do, causal, window, scale,
                           block_q, block_k, block_skip):
    """The flash-style backward: scores recomputed tile by tile from
    (q, k, v, out, lse) with D = rowsum(dO·O); pass 1 gives dq per query
    block, pass 2 dk and dv per kv block over the query blocks that see
    it.  Returns (dq, dk, dv) in the inputs' dtypes.  A roofline counter
    counts its tiles by formula."""
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    g = hq // hkv
    qp, kp, vp, block_q, block_k = _attn_pad(q, k, v, block_q, block_k)
    sqp, skp = qp.shape[2], kp.shape[2]
    nq, nk = sqp // block_q, skp // block_k
    q_off = sk - sq
    qg = qp.reshape(b, hkv, g, sqp, d).to(F32)
    kf, vf = kp.to(F32), vp.to(F32)
    pad_q = (0, 0, 0, sqp - sq)
    dog = F.pad(do.to(F32).reshape(b, hkv, g, sq, dv), pad_q)
    og = F.pad(out.to(F32).reshape(b, hkv, g, sq, dv), pad_q)
    lseg = F.pad(lse.to(F32).reshape(b, hkv, g, sq, 1), pad_q)
    D = torch.sum(dog * og, dim=-1, keepdim=True)        # (b, hkv, g, sqp, 1)

    def rows(t, i):
        return t[:, :, :, i * block_q:(i + 1) * block_q]

    def keys(t, j):
        return t[:, :, j * block_k:(j + 1) * block_k]

    def p_block(qi, ki):
        s = torch.einsum("bhgqd,bhcd->bhgqc", rows(qg, qi) * scale,
                         keys(kf, ki))
        mask = _blk_mask(qi * block_q, block_q, ki, block_k, q_off, sk,
                         causal, window, q.device)
        s = s.masked_fill(~mask, float("-inf"))
        return _where_finite(s, torch.exp(s - rows(lseg, qi)))

    dq_blocks = []
    for qi in range(nq):
        dq_b = torch.zeros((b, hkv, g, block_q, d), dtype=F32, device=q.device)
        lo, hi = _ki_range(qi, nk, causal, window, block_q, block_k, q_off,
                           block_skip)
        for ki in range(lo, hi):
            p = p_block(qi, ki)
            dp = torch.einsum("bhgqv,bhcv->bhgqc", rows(dog, qi), keys(vf, ki))
            ds = p * (dp - rows(D, qi))
            dq_b = dq_b + torch.einsum("bhgqc,bhcd->bhgqd", ds,
                                       keys(kf, ki)) * scale
        dq_blocks.append(dq_b)
    dq = torch.cat(dq_blocks, dim=3)[:, :, :, :sq].reshape(b, hq, sq, d)

    dk_blocks, dv_blocks = [], []
    for ki in range(nk):
        dk_b = torch.zeros((b, hkv, block_k, d), dtype=F32, device=q.device)
        dv_b = torch.zeros((b, hkv, block_k, dv), dtype=F32, device=q.device)
        lo, hi = _qi_range(ki, nq, causal, window, block_q, block_k, q_off,
                           block_skip)
        for qi in range(lo, hi):
            p = p_block(qi, ki)
            do_b = rows(dog, qi)
            dv_b = dv_b + torch.einsum("bhgqc,bhgqv->bhcv", p, do_b)
            dp = torch.einsum("bhgqv,bhcv->bhgqc", do_b, keys(vf, ki))
            ds = p * (dp - rows(D, qi))
            dk_b = dk_b + torch.einsum("bhgqc,bhgqd->bhcd", ds,
                                       rows(qg, qi)) * scale
        dk_blocks.append(dk_b)
        dv_blocks.append(dv_b)
    dk = torch.cat(dk_blocks, dim=2)[:, :, :sk]
    dvv = torch.cat(dv_blocks, dim=2)[:, :, :sk]
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


class BlockedAttention(torch.autograd.Function):
    """Training attention, the twin of the reference's custom-VJP
    ``_attention_xla_core``: the blocked online-softmax forward, saving
    only (q, k, v, out, lse), and the two-pass backward that recomputes
    the scores tile by tile — no (sq, sk) matrix is kept between forward
    and backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k,
                block_skip, p_bf16):
        out, lse = _attention_blocked_fwd(q, k, v, causal, window, scale,
                                          block_q, block_k, block_skip,
                                          p_bf16)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, block_q, block_k, block_skip)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _attention_blocked_bwd(*ctx.saved_tensors, do, *ctx.args)
        return (dq, dk, dv) + (None,) * 7


def attention_blocked(q, k, v, causal=True, window=None, scale=None,
                      block_q: int = 512, block_k: int = 512,
                      block_skip: bool = False, p_bf16: bool = False):
    """Differentiable blocked attention (``BlockedAttention``), the
    reference's ``attention_xla``: q (b, hq, sq, d); k (b, hkv, sk, d);
    v (b, hkv, sk, dv); query i at position ``sk - sq + i``.  A row with
    no live key gives 0.  ``block_skip`` visits only the causally live
    (banded, under a window) tiles; ``p_bf16`` rounds the probabilities
    and values to bf16 for the PV product."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    return BlockedAttention.apply(q, k, v, bool(causal), window, float(scale),
                                  int(block_q), int(block_k),
                                  bool(block_skip), bool(p_bf16))


def attention_prefill(q, k, v, *, window=None, scale=None,
                      block_q: int = 512, block_k: int = 512,
                      block_skip: bool = False, p_bf16: bool = False):
    """Causal attention of a prefill (no cache, no gradient): the blocked
    online-softmax forward of ``attention_blocked``, as the reference's
    prefill runs it — tiles of ``block_q`` x ``block_k`` scores, never
    the whole (sq, sk) matrix; ``block_skip`` visits only the causally
    live (banded, under a window) tiles; a row with no live key gives 0.

    Scores that fit one tile, in which every query sees at least its own
    key, take one masked softmax of that tile (fp32 probabilities only:
    ``p_bf16`` rounds them unnormalised, as the online softmax does): the
    same tile in a few launches instead of the loop's two dozen, at the
    prompt lengths a serving admission mostly sees."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    sq, sk = q.shape[2], k.shape[2]
    one_tile = sq <= min(block_q, sk) and sk <= block_k
    with torch.no_grad():
        if one_tile and not p_bf16 and (window is None or window > 0):
            return _softmax_attention(q, k, v, True, window, scale)
        out, _ = _attention_blocked_fwd(q, k, v, True, window, float(scale),
                                        int(block_q), int(block_k),
                                        bool(block_skip), bool(p_bf16))
    return out


def attention_decode(q, k, v, kv_valid, scale: Optional[float] = None,
                     partials: bool = False):
    """Single-step decode attention over a cache.

    q: (b, hq, 1, d); k: (b, hkv, S, d); v: (b, hkv, S, dv);
    kv_valid: (b, S) bool or (S,) — which cache slots hold real keys.
    ``partials`` (one shard of a cache split over the sequence): the
    unnormalised (acc (b, hq, dv), ml (b, hq, 2)) fp32 partials under the
    kernels' rule (a shard with no valid key: m = NEG_INF, l = 0), for
    ``kernels.flash_attention.combine_decode_partials``.
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
    if partials:
        from ..kernels.flash_attention import _masked_partials
        p, m, l = _masked_partials(s, mask)
        acc = torch.einsum("bhgqc,bhcv->bhgqv", p, v.to(F32))
        return (acc.reshape(b, hq, -1),
                torch.cat([m, l], -1).reshape(b, hq, 2))
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


def split_heads(t, *shape):
    """``t.reshape(*shape)`` where the last dim of ``t`` (heads x head
    dim) becomes shape[-2:].  On a mesh a mesh axis that splits that dim
    but not the head count (24 heads over 16 ranks) is gathered first:
    DTensor cannot split a head between ranks."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh, last, heads = t.device_mesh, t.dim() - 1, shape[-2]
        pls = list(t.placements)
        n = 1
        for m, pl in enumerate(pls):
            if isinstance(pl, Shard) and pl.dim == last:
                n *= mesh.size(m)
        if heads % n:
            t = t.redistribute(mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == last
                else pl for pl in pls])
    return t.reshape(*shape)


def merge_heads(t, *shape):
    """``t.reshape(*shape)`` where the last two dims of ``t`` (heads,
    head dim) become one.  On a mesh its gradient keeps the merged
    tensor's layout: the output projection's backward would hand back a
    gradient split over the merged dim, which DTensor cannot unflatten
    into heads that do not divide the mesh axis."""
    return pin_grad(t.reshape(*shape))


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
    q = split_heads(q, b, s, hq, hd)
    k = split_heads(k, b, s, hkv, hd)
    v = split_heads(v, b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def attention_apply(cfg, p, x, *, window: Optional[int] = None,
                    theta: Optional[float] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    pos=None, store_rows: Optional[torch.Tensor] = None,
                    train: bool = False):
    """Pre-norm attention with residual.  Train/prefill when cache is
    None, both the blocked online softmax with the config's tiles,
    ``attn_block_skip`` and ``attn_p_bf16`` (``train``: the
    differentiable ``attention_blocked``; prefill: ``attention_prefill``);
    single-token decode otherwise: ``cache`` holds k, v of shape
    (b, hkv, S, hd) (int8 caches also k_scale, v_scale of (b, hkv, S,
    1)), written in place, and ``pos`` is a (b,) tensor (or a host int
    for every row) — each row decodes at its own position, as the
    reference's vmap over slots does.  A cache of exactly ``window``
    slots is the rolling ring buffer.  An int8 cache is written through
    ``kv_quantize_store`` at ``store_rows`` (``dense_store_rows``; the
    same for every layer, so callers may compute it once per step).  With
    ``cfg.decode_flash`` the read goes through
    ``kernels.flash_attention.flash_attention_decode``.  Returns (y,
    cache); without a cache, the second item is the block's rotated K and
    V, {"k", "v"} of (b, hkv, s, hd), which a prefill emits (computed
    once, as the reference's compiled prefill does)."""
    theta = theta if theta is not None else cfg.rope_theta
    b, s, d = x.shape
    h = rmsnorm(x, p["norm"])
    h = constrain(h, "batch", None, "embed")
    q, k, v = _qkv(cfg, p, h)
    if cache is None:
        tiles = dict(window=window, block_q=cfg.attn_block_q,
                     block_k=cfg.attn_block_k,
                     block_skip=cfg.attn_block_skip, p_bf16=cfg.attn_p_bf16)

        def core(q, k, v):
            # (b, s, h, d) in and out: rope, then the tiled attention.
            cs = _rope_angles(torch.arange(s, device=q.device),
                              cfg.head_dim, theta, q.device)
            q, k = _rotate(q, *cs), _rotate(k, *cs)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            if train:
                o = attention_blocked(q, k, v, causal=True, **tiles)
            else:
                o = attention_prefill(q, k, v, **tiles)
            return o.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        qa, ka = head_axes(cfg, q)
        o, k, v = local_region(
            core, (q, k, v), (("batch", None, qa, None),
                              ("batch", None, ka, None),
                              ("batch", None, ka, None)), (0, 1, 2))
        new_cache = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
        o = o.transpose(1, 2)
    elif is_dtensor(cache["k"]):
        o = _decode_on_mesh(cfg, q, k, v, cache, pos, window, theta)
        new_cache = cache
    else:
        o = _dense_decode(cfg, q, k, v, cache, decode_pos(pos, b, x.device),
                          window, theta, store_rows)
        new_cache = cache
    y = merge_heads(o.transpose(1, 2), b, s, -1) @ p["wo"]
    y = constrain(y, "batch", None, "embed")
    return x + y, new_cache


def mesh_rows(t: torch.Tensor, like, dims: Dict[int, int]):
    """``t`` (a plain tensor, whole on every rank, or a DTensor) as a
    DTensor on ``like``'s mesh, split as ``like`` is: ``like``'s tensor
    dim ``k`` sharded over a mesh dim becomes ``t``'s dim ``dims[k]``
    sharded over it; every other mesh dim replicates.  Splitting a
    replicated tensor is a local slice, no collective."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    want = [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in like.placements]
    if not is_dtensor(t):
        t = DTensor.from_local(t.to(mesh.device_type), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, want)


def shard_index(t, dim: int) -> Tuple[int, int]:
    """(index, count) of this rank's shard of DTensor ``t`` along tensor
    dim ``dim``: row-major over the mesh dims that split it, in mesh-dim
    order, as DTensor lays the shards out."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    idx, n = 0, 1
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(m) + mesh.get_local_rank(m)
            n *= mesh.size(m)
    return idx, n


def _masked_write_work(dst, index, new, keep):
    """The rows a masked write moves: the old rows read, the new read and
    written (the whole ``dst`` is not read, as a gather's count would
    have it)."""
    return 0.0, 3.0 * new.numel() * new.element_size()


@_count.by_formula(_masked_write_work)
def masked_row_write(dst, index, new, keep):
    """``dst[index] = new`` where ``keep``, the old value elsewhere: the
    drop-mode write of a row whose slot lies in another rank's shard (a
    mask, never an out-of-range index).  In place."""
    dst[index] = torch.where(keep, new, dst[index])


def _dense_decode(cfg, q, k, v, cache, pos, window, theta, store_rows=None,
                  seq=(0, 1), S=None):
    """A dense decode step's attention on plain tensors: rope at the (b,)
    positions ``pos``, the step's K/V written into ``cache`` (b, hkv, S,
    hd) in place, then the read.  q, k, v: (b, 1, h, hd).  Returns o (b,
    hq, 1, hd).

    ``seq`` = (index, count): ``cache`` is shard ``index`` of ``count``
    along the sequence of a cache of ``S`` slots.  The write then goes to
    this shard only (the slot shifted by the shard's first one, a row
    whose slot lies elsewhere dropped by a mask, never an out-of-range
    index: B2's store drops its row), and the read returns the shard's
    split-KV partials (acc (b, hq, hd), ml (b, hq, 2)) with the global
    key offset, from B3 or the plain read, for
    ``kernels.flash_attention.combine_decode_partials``."""
    b = q.shape[0]
    S_l = cache["k"].shape[2]
    S = S or S_l
    off = seq[0] * S_l
    ring = window is not None and S == window
    cs = _rope_angles(pos[:, None, None], cfg.head_dim, theta, q.device)
    q = _rotate(q, *cs).transpose(1, 2)              # (b, hq, 1, hd)
    k = _rotate(k, *cs).transpose(1, 2)              # (b, hkv, 1, hd)
    v = v.transpose(1, 2)
    slot = decode_slot(pos, S, window) - off
    keep = None
    if seq[1] > 1:
        keep = (slot >= 0) & (slot < S_l)
        slot = slot.clamp(0, S_l - 1)
    rows = torch.arange(b, device=q.device)
    if cfg.kv_cache_dtype == "int8":
        # quantize K and V into their slots: one launch of B2.
        if store_rows is None:
            store_rows = kv_store_rows(rows, slot, k.shape[1], S_l, keep)
        kv_quantize_store(
            k[:, :, 0].contiguous(), v[:, :, 0].contiguous(),
            cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            store_rows)
    else:
        for name, t in _to_cache(cfg, {"k": k[:, :, 0], "v": v[:, :, 0]},
                                 cache["k"].dtype).items():
            if keep is None:
                cache[name][rows, :, slot] = t
            else:
                masked_row_write(cache[name], (rows, slice(None), slot), t,
                                 keep[:, None, None])
    full = _from_cache(cache, q.dtype)               # (b, hkv, S_l, hd)
    if cfg.decode_flash:
        from ..kernels.flash_attention import flash_attention_decode
        return flash_attention_decode(
            q.contiguous(), full["k"], full["v"],
            pos.to(torch.int32).contiguous(),
            window=window if ring else None, ring=ring, key_offset=off,
            partials=seq[1] > 1)
    kpos = torch.arange(S_l, device=q.device)[None, :] + off
    valid = kpos <= pos[:, None]
    if ring:
        valid |= (pos >= window)[:, None]
    return attention_decode(q, full["k"], full["v"], valid,
                            partials=seq[1] > 1)


def _decode_on_mesh(cfg, q, k, v, cache, pos, window, theta):
    """A dense decode step's attention on a ``DeviceMesh``:
    ``_dense_decode`` on each rank's local shards (``local_region``),
    with the cache's placements.  q, k, v: (b, 1, h, hd) DTensors, taken
    to the cache's batch and kv-head splits (q's heads with its kv heads'
    groups).  Where the cache splits over the sequence (``kv_seq`` or
    ``seq_sharded``) each rank's shard is one more split of split-KV:
    ``combine_gathered``.  Returns o (b, hq, 1, hd) as a DTensor."""
    from ..kernels.flash_attention import combine_decode_partials
    ck = cache["k"]
    b, S = ck.shape[0], ck.shape[2]
    seq = shard_index(ck, 2)
    names = list(cache)
    ins = [mesh_rows(t, ck, {0: 0, 1: 2}) for t in (q, k, v)] + [
        mesh_rows(decode_pos(pos, b, ck.device_mesh.device_type), ck,
                  {0: 0})] + [cache[n] for n in names]
    free = [None] * len(ins)

    def local(q, k, v, pos, *leaves):
        out = _dense_decode(cfg, q, k, v, dict(zip(names, leaves)), pos,
                            window, theta, seq=seq, S=S)
        return out if seq[1] == 1 else tuple(t[None] for t in out)

    ik = 4 + names.index("k")
    if seq[1] == 1:
        return local_region(local, ins, free, [(ik, {0: 0, 1: 1})])
    parts = local_region(local, ins, free, [(ik, {2: 0, 0: 1, 1: 2})] * 2)
    return combine_gathered(
        lambda acc, ml: combine_decode_partials(acc, ml).to(q.dtype)[
            :, :, None], parts, (), {1: 0, 2: 1})


def combine_gathered(fn, parts, extra, dims):
    """Split-KV partials of a sequence-split cache, (acc, ml) DTensors
    split on their leading dim over the sequence's mesh dims, gathered to
    every rank (an all-gather in group-rank order), then ``fn(acc, ml,
    *extra)`` on the local shards: it combines them in fp32 in that
    order (``combine_decode_partials``), so every replica holds the same
    bits.  The output is sharded as acc is, its dim ``k`` moved to
    ``dims[k]``."""
    from torch.distributed.tensor import Replicate, Shard
    whole = [Replicate() if p == Shard(0) else p for p in parts[0].placements]
    acc, ml = (t.redistribute(t.device_mesh, whole) for t in parts)
    args = (acc, ml, *extra)
    return local_region(fn, args, [None] * len(args), [(0, dims)])


def head_axes(cfg, q) -> Tuple[Optional[str], Optional[str]]:
    """The logical axes of the query and the K/V heads for attention on
    local shards: each shard's query heads must meet their own K/V heads,
    so the heads shard only where both counts divide the mesh axes (or
    one K/V head is replicated to every shard); otherwise neither does.
    ``q`` is a DTensor on a mesh (else any answer serves)."""
    if not is_dtensor(q):
        return "heads", "kv_heads"
    mesh = q.device_mesh
    sq = spec_for(("heads",), mesh, (cfg.n_heads,))[0]
    skv = spec_for(("kv_heads",), mesh, (cfg.n_kv_heads,))[0]
    if sq == skv:
        return "heads", "kv_heads"
    if skv is None and cfg.n_kv_heads == 1:
        return "heads", None
    return None, None


def cross_attention_apply(cfg, p, x, cond):
    """musicgen's cross-attention block with residual (the reference's
    ``cross_apply``): x is RMS-normed, ``cond`` (b, lc, d) is not; no
    rope; K/V projected from ``cond`` on every call (prefill and each
    decode step alike), every query attending every cond row through the
    plain ``attention_decode`` (no kernel, in the reference either)."""
    b, s, _ = x.shape
    lc = cond.shape[1]
    hq, hd = cfg.n_heads, cfg.head_dim
    h = rmsnorm(x, p["norm"])
    q = split_heads(h @ p["wq"], b, s, hq, hd).transpose(1, 2)
    k = split_heads(cond @ p["wk"], b, lc, hq, hd).transpose(1, 2)
    v = split_heads(cond @ p["wv"], b, lc, hq, hd).transpose(1, 2)
    heads = ("batch", "heads", None, None)
    o = local_region(
        lambda q, k, v: attention_decode(
            q, k, v, torch.ones(lc, dtype=torch.bool, device=q.device)),
        (q, k, v), (heads, heads, heads), (0,))
    y = merge_heads(o.transpose(1, 2), b, s, hq * hd) @ p["wo"]
    return x + constrain(y, "batch", None, "embed")


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
    # sharded serving: heads column-split, wo row-split, so each rank
    # holds a partial sum over its heads.
    y = psum_parts(o.transpose(1, 2).reshape(b, s, -1) @ p["wo"])
    return x + constrain(y, "batch", None, "embed"), pages


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
    """One layer's dense slot cache, (batch, hkv, S, hd) per leaf.  On a
    mesh its sequence dim may split, as the reference's: over "model"
    (``kv_seq``) with ``cfg.decode_seq_shard``, where the kv heads leave
    that axis free, or over "data" (``seq_sharded``) at batch 1, the
    long-context cells; a sliding-window cache never splits."""
    S = min(max_seq, window) if window else max_seq
    if window is None and cfg.decode_seq_shard:
        seq_ax = "kv_seq"
    elif window is None and batch == 1:
        seq_ax = "seq_sharded"
    else:
        seq_ax = None
    return _kv_leaves(cfg, (batch, cfg.n_kv_heads, S, cfg.head_dim),
                      ("batch", "kv_heads", seq_ax, None))


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


# --- MLA (deepseek-v2) ---------------------------------------------------------------


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


def mla_latent(cfg, p, x):
    """Projections of a block input x (b, s, d): ``q`` (b, s, hq, nope +
    rope) before rotary, the latent rows ``c_kv`` (b, s, lora) and the
    un-rotated shared rope head (b, s, rope)."""
    b, s, _ = x.shape
    lora = cfg.kv_lora_rank
    h = rmsnorm(x, p["norm"])
    q = split_heads(h @ p["wq"], b, s, cfg.n_heads,
                    cfg.qk_nope_dim + cfg.qk_rope_dim)
    dkv = h @ p["w_dkv"]
    return q, rmsnorm(dkv[..., :lora], p["kv_norm"]), dkv[..., lora:]


def _mla_absorbed(cfg, p, q_nope, q_rope, CC, CR, valid, dtype,
                  partials: bool = False):
    """Absorbed attention on the latent rows: q_nope (b, s, hq, nope) is
    folded through w_uk into the latent space, scored against CC (b, S,
    lora) fp32 plus q_rope against the shared rope head CR (b, S, rope),
    masked by ``valid`` (b, s, S) and read back through w_uv.  Returns
    (b, s, hq * vd) in ``dtype``.  With ``partials`` (one decode token,
    s = 1) the rows are one split of split-KV: returns its unnormalised
    (acc (b, hq, lora), ml (b, hq, 2)) over the latent rows, for
    ``combine_decode_partials`` and then ``_mla_read_back``."""
    nope = cfg.qk_nope_dim
    hq = q_nope.shape[2]              # this shard's heads on a mesh
    w_uk = p["w_uk"].reshape(cfg.kv_lora_rank, hq, nope).to(F32)
    q_eff = torch.einsum("bshn,lhn->bshl", q_nope.to(F32), w_uk)
    logits = (torch.einsum("bshl,bSl->bhsS", q_eff, CC)
              + torch.einsum("bshr,bSr->bhsS", q_rope.to(F32), CR)) \
        / float(np.sqrt(nope + cfg.qk_rope_dim))
    if partials:
        from ..kernels.flash_attention import _masked_partials
        pr, m, l = _masked_partials(logits, valid[:, None])
        acc = torch.einsum("bhsS,bSl->bhsl", pr, CC)[:, :, 0]
        return acc, torch.cat([m, l], -1)[:, :, 0]
    logits = logits.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(logits, -1)
    ctx = torch.einsum("bhsS,bSl->bshl", probs, CC)
    return _mla_read_back(cfg, p["w_uv"], ctx, dtype)


def _mla_read_back(cfg, w_uv, ctx, dtype):
    """The latent context ctx (b, s, hq, lora) fp32 read back through
    w_uv: (b, s, hq * vd) in ``dtype``."""
    b, s, hq, lora = ctx.shape
    w_uv = w_uv.reshape(lora, hq, cfg.v_head_dim).to(F32)
    o = torch.einsum("bshl,lhv->bshv", ctx, w_uv).to(dtype)
    return o.reshape(b, s, hq * cfg.v_head_dim)


def _mla_decode(cfg, p, q, c_kv, k_rope_raw, cache, pos, dtype,
                seq=(0, 1), S=None):
    """MLA's absorbed decode step on plain tensors: rope at the (b,)
    positions ``pos``, the step's latent row (c_kv (b, 1, lora), the
    un-rotated k_rope (b, 1, rope)) written into ``cache`` {"c_kv",
    "k_rope"} (b, S, .) in place at ``decode_slot`` (clamped, as the
    reference's dynamic_update_slice), keys ``<= pos`` valid.  Returns
    (b, 1, hq * vd).  ``seq`` = (index, count) as ``_dense_decode``
    takes it: the write goes to this shard only (a masked row, never an
    out-of-range index) and the read returns the shard's split-KV
    partials over the latent rows (``_mla_absorbed``)."""
    nope = cfg.qk_nope_dim
    cc, cr = cache["c_kv"], cache["k_rope"]
    b, S_l = cc.shape[:2]
    S = S or S_l
    off = seq[0] * S_l
    q_nope = q[..., :nope]
    q_rope = rope(q[..., nope:], pos[:, None, None], cfg.rope_theta)
    k_rope = rope(k_rope_raw, pos[:, None], cfg.rope_theta)  # (b, 1, rp)
    rows = torch.arange(b, device=cc.device)
    slot = decode_slot(pos, S) - off
    if seq[1] == 1:
        cc[rows, slot] = c_kv[:, 0].to(cc.dtype)
        cr[rows, slot] = k_rope[:, 0].to(cr.dtype)
    else:
        keep = (slot >= 0) & (slot < S_l)
        slot = slot.clamp(0, S_l - 1)
        for dst, new in ((cc, c_kv[:, 0]), (cr, k_rope[:, 0])):
            masked_row_write(dst, (rows, slot), new.to(dst.dtype),
                             keep[:, None])
    valid = ((torch.arange(S_l, device=cc.device)[None, :] + off)
             <= pos[:, None])[:, None, :]                   # (b, 1, S_l)
    return _mla_absorbed(cfg, p, q_nope, q_rope, cc.to(F32), cr.to(F32),
                         valid, dtype, partials=seq[1] > 1)


def mla_apply(cfg, p, x, *, cache: Optional[Dict[str, torch.Tensor]] = None,
              pos=None, train: bool = False):
    """Pre-norm MLA attention with residual.  Train/prefill when cache is
    None (the latent rows expanded to per-head K/V, causal attention in
    the config's tiles and ``attn_block_skip``: ``train`` through
    ``attention_blocked``, prefill through ``attention_prefill``; fp32
    probabilities, as the reference's MLA never sets ``attn_p_bf16``);
    else absorbed single-token decode on the compressed cache
    (``_mla_decode``): ``cache`` holds c_kv (b, S, lora) and k_rope (b,
    S, rope), bf16, written in place, and ``pos`` is a (b,) tensor or a
    host int — each row decodes at its own position, as the reference's
    vmap over slots does.  Returns (y, cache); without a
    cache, the second item is the latent rows a prefill emits, {"c_kv"
    (b, s, lora), "k_rope" (b, s, rope) rotated}, for
    ``mla_emit_latent``."""
    b, s, _ = x.shape
    hq, nope, rp, vd = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim)
    q, c_kv, k_rope_raw = mla_latent(cfg, p, x)
    if cache is None:
        k_nope = split_heads(c_kv @ p["w_uk"], b, s, hq, nope)
        vv = split_heads(c_kv @ p["w_uv"], b, s, hq, vd)
        tiles = dict(scale=1.0 / np.sqrt(nope + rp),
                     block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
                     block_skip=cfg.attn_block_skip)

        def core(q, k_rope_raw, k_nope, vv):
            # rope, the shared rope head beside each head's K, attention;
            # (b, s, h, .) in and out, on a mesh each shard's rows and heads.
            positions = torch.arange(s, device=q.device)
            q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions,
                                                 cfg.rope_theta)
            k_rope = rope(k_rope_raw, positions, cfg.rope_theta)
            qq = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
            kk = torch.cat([k_nope, k_rope[:, :, None].expand(
                *k_nope.shape[:3], rp)], -1).transpose(1, 2)
            if train:
                o = attention_blocked(qq, kk, vv.transpose(1, 2),
                                      causal=True, **tiles)
            else:
                o = attention_prefill(qq, kk, vv.transpose(1, 2), **tiles)
            return o.transpose(1, 2), k_rope

        heads = ("batch", None, "heads", None)
        o, k_rope = local_region(core, (q, k_rope_raw, k_nope, vv),
                                 (heads, ("batch", None, None), heads, heads),
                                 (0, 1))
        o = merge_heads(o, b, s, -1)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
    elif is_dtensor(cache["c_kv"]):
        o = _mla_decode_on_mesh(cfg, p, q, c_kv, k_rope_raw, cache, pos,
                                x.dtype)
        new_cache = cache
    else:
        o = _mla_decode(cfg, p, q, c_kv, k_rope_raw, cache,
                        decode_pos(pos, b, x.device), x.dtype)
        new_cache = cache
    return x + constrain(o @ p["wo"], "batch", None, "embed"), new_cache


def _mla_decode_on_mesh(cfg, p, q, c_kv, k_rope_raw, cache, pos, dtype):
    """MLA's absorbed decode step on a ``DeviceMesh``: ``_mla_decode`` on
    each rank's local shards (``local_region``): the latent cache
    {"c_kv", "k_rope"} (b, S, .) with its placements (rows over the
    batch axes, the sequence over "data" at batch 1), q with its heads as
    they split.  A sequence-split cache's partials over the latent rows
    go through ``combine_gathered``, then are read back through
    ``w_uv``.  Returns (b, 1, hq * vd) as a DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    from ..kernels.flash_attention import combine_decode_partials
    cc = cache["c_kv"]
    mesh = cc.device_mesh
    b, S = cc.shape[:2]
    seq = shard_index(cc, 1)

    # q: the cache's row split, else its own head split; the step's
    # latent rows as q's rows; the weights split as q's heads.
    q_pl = [Shard(0) if isinstance(pc, Shard) and pc.dim == 0
            else Replicate() if isinstance(pc, Shard)
            else pq if isinstance(pq, Shard) and pq.dim == 2
            else Replicate() for pc, pq in zip(cc.placements, q.placements)]
    rows_pl = [pq if pq == Shard(0) else Replicate() for pq in q_pl]
    w_pl = [Shard(1) if pq == Shard(2) else Replicate() for pq in q_pl]
    ins = [q.redistribute(mesh, q_pl),
           *(t.redistribute(mesh, rows_pl) for t in (c_kv, k_rope_raw)),
           mesh_rows(decode_pos(pos, b, mesh.device_type), cc, {0: 0}),
           *(p[n].redistribute(mesh, w_pl) for n in ("w_uk", "w_uv")),
           cc, cache["k_rope"]]
    free = [None] * len(ins)

    def local(q, c_kv, k_rope_raw, pos, w_uk, w_uv, cc, cr):
        out = _mla_decode(cfg, {"w_uk": w_uk, "w_uv": w_uv}, q, c_kv,
                          k_rope_raw, {"c_kv": cc, "k_rope": cr}, pos,
                          dtype, seq=seq, S=S)
        return out if seq[1] == 1 else tuple(t[None] for t in out)

    if seq[1] == 1:
        return local_region(local, ins, free, (0,))
    # the partials: the sequence's mesh dims on a leading dim, q's rows
    # and heads on the next two.
    part_pl = [Shard(0) if pc == Shard(1) else Shard(pq.dim // 2 + 1)
               if isinstance(pq, Shard) else Replicate()
               for pc, pq in zip(cc.placements, q_pl)]
    parts = local_region(local, ins, free, [part_pl, part_pl])
    return combine_gathered(
        lambda acc, ml, w_uv: _mla_read_back(
            cfg, w_uv, combine_decode_partials(acc, ml)[:, None], dtype),
        parts, (ins[5],), {1: 0, 2: 2})


def mla_emit_latent(latent, cache_len: Optional[int] = None):
    """The latent cache rows a prefill emits from the rows that
    ``mla_apply`` returns without a cache: c_kv (b, Sc, lora) and the
    rotated k_rope (b, Sc, rope), bf16, zero past the prompt."""
    c_kv, k_rope = latent["c_kv"], latent["k_rope"]
    s = c_kv.shape[1]
    Sc = cache_len or s
    if Sc > s:
        c_kv = F.pad(c_kv, (0, 0, 0, Sc - s))
        k_rope = F.pad(k_rope, (0, 0, 0, Sc - s))
    return {"c_kv": c_kv.to(torch.bfloat16),
            "k_rope": k_rope.to(torch.bfloat16)}


def mla_apply_paged(cfg, p, x, *, pages: Dict[str, torch.Tensor],
                    block_tab: torch.Tensor, pos: torch.Tensor,
                    last_idx: Optional[torch.Tensor] = None,
                    cache_offset: Optional[torch.Tensor] = None,
                    verify: bool = False, write_idx=None):
    """MLA absorbed attention against a *paged* latent cache.

    ``pages``: this layer's {"c_kv" (n_pages, page, lora), "k_rope"
    (n_pages, page, rope)} bf16 pools, written in place — no per-head
    axis (the MLA memory win, page-granular).  x: (b, s, d) — s == 1 a
    decode step, s > 1 a prefill chunk at positions pos..pos+s-1, or
    with ``verify`` a speculative span.  The PRE-write pool is gathered
    (table entries clamped into ``[0, n_pages)``) and the chunk's own
    latent rows overlaid: a chunk reads them at full precision, a decode
    step or verify span pool-rounded (what sequential decode reads back),
    so spec == plain and paged == dense hold bit for bit.  The append
    writes only the kept rows (``paged_write_index``; ``write_idx`` is
    its result when the caller computed it once per forward) where the
    reference scatters every row with ``mode="drop"``.  Sharded serving
    splits the latent pool over its last dim (seen from the pool's
    width): the write keeps this rank's slice of the full ``c_kv`` (its
    ``w_dkv`` is replicated), the read gathers the tiles back to the
    full rank.  Returns (y, pages).
    """
    b, s, _ = x.shape
    nope = cfg.qk_nope_dim
    q, c_kv, k_rope_raw = mla_latent(cfg, p, x)
    positions = pos.to(torch.int64)[:, None] + torch.arange(
        s, device=x.device)                                    # (b, s)
    k_rope = rope(k_rope_raw, positions, cfg.rope_theta)
    q_nope = q[..., :nope]
    q_rope = rope(q[..., nope:], positions[:, :, None], cfg.rope_theta)

    cp, rpool = pages["c_kv"], pages["k_rope"]
    n_pages, page, lora_local = cp.shape
    n_blocks = block_tab.shape[1]
    if write_idx is None:
        write_idx = paged_write_index(block_tab, pos, s, page, n_pages,
                                      last_idx, cache_offset)

    # read: pre-write pool gather + own-chunk overlay.
    bt = block_tab.to(torch.int64).clamp(0, n_pages - 1)
    S = n_blocks * page
    cc = gather_parts(cp[bt].reshape(b, S, lora_local), -1).to(F32)
    cr = rpool[bt].reshape(b, S, -1).to(F32)
    if s == 1 or verify:                             # pool-rounded own rows
        cl = c_kv.to(cp.dtype).to(F32)
        rl = k_rope.to(rpool.dtype).to(F32)
    else:
        cl, rl = c_kv.to(F32), k_rope.to(F32)
    CC = torch.cat([cc, cl], dim=1)                  # (b, S + s, lora)
    CR = torch.cat([cr, rl], dim=1)
    kpos = torch.arange(S, device=x.device).expand(b, S)
    kpos_cat = torch.cat([kpos, positions], dim=1)
    pre_ok = torch.cat([kpos < positions[:, :1],
                        torch.ones((b, s), dtype=torch.bool,
                                   device=x.device)], dim=1)
    valid = (kpos_cat[:, None, :] <= positions[:, :, None]) \
        & pre_ok[:, None, :]                         # (b, s, S + s)
    o = _mla_absorbed(cfg, p, q_nope, q_rope, CC, CR, valid, x.dtype)

    # append: the kept latent rows (this rank's slice of them) into the
    # pools.
    rows_b, rows_s, wp, wo = write_idx
    c_loc = c_kv.narrow(-1, part_index() * lora_local, lora_local)
    cp[wp, wo] = c_loc[rows_b, rows_s].to(cp.dtype)
    rpool[wp, wo] = k_rope[rows_b, rows_s].to(rpool.dtype)
    # sharded serving: query heads column-split, wo row-split.
    return x + constrain(psum_parts(o @ p["wo"]), "batch", None,
                         "embed"), pages


def mla_paged_cache_decl(cfg, n_pages: int, page_size: int
                         ) -> Dict[str, Decl]:
    """One MLA layer's latent page pool: (n_pages, page, lora) rows of the
    compressed cache plus the shared rope head (n_pages, page, rope),
    bf16 whatever ``kv_cache_dtype`` says (as in the reference)."""
    return {
        "c_kv": Decl((n_pages, page_size, cfg.kv_lora_rank),
                     (None, None, "lora"), torch.bfloat16, init="zeros"),
        "k_rope": Decl((n_pages, page_size, cfg.qk_rope_dim),
                       (None, None, None), torch.bfloat16, init="zeros"),
    }


def mla_cache_decl(cfg, batch: int, max_seq: int) -> Dict[str, Decl]:
    """Dense slot latent cache: c_kv (batch, max_seq, lora) and k_rope
    (batch, max_seq, rope), bf16."""
    seq_ax = "seq_sharded" if batch == 1 else None
    return {
        "c_kv": Decl((batch, max_seq, cfg.kv_lora_rank),
                     ("batch", seq_ax, "lora"), torch.bfloat16, init="zeros"),
        "k_rope": Decl((batch, max_seq, cfg.qk_rope_dim),
                       ("batch", seq_ax, None), torch.bfloat16, init="zeros"),
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
    h = constrain(h, "batch", None, "embed")
    if "w_gate" in p:
        hh = swiglu(h @ p["w_gate"], h @ p["w_up"])
    else:   # jax.nn.gelu's default is the tanh approximation
        hh = F.gelu((h @ p["w_up"]).to(F32), approximate="tanh").to(h.dtype)
    hh = constrain(hh, "batch", None, "ff")
    # sharded serving: w_up / w_gate column-split over ff, w_down row-split.
    return x + constrain(psum_parts(hh @ p["w_down"]), "batch", None,
                         "embed")


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


def _moe_dispatch(cfg, p, xg, dtype):
    """Capacity-bounded dispatch of G token groups at once (the
    reference's ``_moe_dispatch_combine``, vmapped over groups when G >
    1).  xg: (G, T, d).  Returns the dispatch tensor (E, G * cap, d) —
    expert-major, so the expert products are one batched matmul over the
    experts whatever G is — and the routing (flat_e, safe_pos, keep,
    gates), each (G, T * k) but gates (G, T, k), as the reference's.

    Top-k: the first k of a stable descending sort, so tied logits pick
    the lower expert index, as ``lax.top_k`` does.  Copies are numbered
    token-major (``jnp.repeat(x, k)``); each expert's kept copies are its
    first ``cap`` in that order.  Kept (expert, slot) pairs are unique,
    so each is written once, no accumulation; dropped copies go to one
    spare row past the tensor, never read."""
    G, T, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = (xg @ p["router"]).to(F32)                      # (G, T, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k], dim=-1).to(dtype)   # (G, T, k)
    cap = int(np.ceil(T * k / E * cfg.capacity_factor))
    cap = -(-max(cap, 8) // 8) * 8

    flat_e = idx[..., :k].reshape(G, T * k)                  # (G, T·k)
    onehot = F.one_hot(flat_e, E)                            # (G, T·k, E)
    pos_in_e = torch.gather(onehot.cumsum(dim=1) - 1, 2,
                            flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    safe_pos = torch.where(keep, pos_in_e, cap - 1)

    row = _expert_rows(flat_e, safe_pos, cap)
    spare = E * G * cap
    buf = torch.zeros((spare + 1, d), dtype=dtype, device=xg.device)
    buf[torch.where(keep, row, spare).reshape(-1)] = \
        xg.to(dtype).repeat_interleave(k, dim=1).reshape(-1, d)
    disp = buf[:spare].view(E, G * cap, d)
    return disp, (flat_e, safe_pos, keep, gates)


def _expert_rows(flat_e, safe_pos, cap: int) -> torch.Tensor:
    """Row of each (group, copy) in the expert-major (E, G, cap) layout,
    flattened."""
    G = flat_e.shape[0]
    g = torch.arange(G, device=flat_e.device)[:, None]
    return (flat_e * G + g) * cap + safe_pos


def _moe_combine(out_e, meta, dtype):
    """Gather each copy's expert output (zero where dropped), weight it
    by its gate, sum over the k copies, cast: the reference's rounding
    points.  out_e: (E, G * cap, d) -> (G, T, d)."""
    flat_e, safe_pos, keep, gates = meta
    G, T, k = gates.shape
    d = out_e.shape[-1]
    row = _expert_rows(flat_e, safe_pos, out_e.shape[1] // G)
    y_rep = out_e.reshape(-1, d)[row.reshape(-1)].reshape(G, T * k, d) \
        * keep[..., None].to(out_e.dtype)
    return (y_rep.reshape(G, T, k, d) * gates[..., None]).sum(2).to(dtype)


def moe_groups(cfg, b: int, s: int, row_capacity: bool = False) -> int:
    """Token groups of one MoE call on x (b, s, d), each with its own
    capacity.  Shared capacity (one batched call, as the reference's
    paged steps and ``greedy_generate``): ``cfg.moe_groups`` when it
    divides the b·s tokens into groups of at least 8, else 1.
    ``row_capacity`` (the dense-slot steps, where the reference vmaps a
    single-row forward): each row on its own, that row's s tokens split
    by the same rule."""
    G = cfg.moe_groups
    T = s if row_capacity else b * s
    per = G if (G and T % G == 0 and T // G >= 8) else 1
    return per * b if row_capacity else per


def moe_apply(cfg, p, x, row_capacity: bool = False):
    """Top-k MoE with capacity-bounded scatter dispatch, SwiGLU experts
    and gate-weighted combine, plus ``n_shared_experts`` always-on
    experts; groups of tokens (``moe_groups``) each have their own
    capacity.  Returns x + y."""
    b, s, d = x.shape
    h = rmsnorm(x, p["norm"])
    h = constrain(h, "batch", None, "embed")
    G = moe_groups(cfg, b, s, row_capacity)
    # on a mesh each rank dispatches its own groups when the groups split
    # over the rows' shards; otherwise every rank dispatches all tokens
    # (the capacity is per group), as the reference's global dispatch.
    grouped = _groups_follow_rows(h, G)
    hg = (h if grouped else constrain(h, None, None, "embed")).reshape(
        G, b * s // G, d)
    rows = "moe_groups" if grouped else None

    def dispatch(xg, router):
        disp, meta = _moe_dispatch(cfg, {"router": router}, xg, x.dtype)
        return (disp,) + meta

    g_only = (0, (0, None, None))          # sharded over the groups only
    disp, *meta = local_region(
        dispatch, (hg, p["router"]), ((rows, None, "embed"), (None, None)),
        ((0, (1, None, 2)), g_only, g_only, g_only, g_only))
    disp = constrain(disp, "experts", rows, "embed")
    hh = swiglu(torch.bmm(disp, p["w_gate"]), torch.bmm(disp, p["w_up"]))
    hh = constrain(hh, "experts", rows, "ff")
    out_e = torch.bmm(hh, p["w_down"])                       # (E, G·cap, d)
    out_e = constrain(out_e, "experts", rows, "embed")
    y = local_region(
        lambda oe, fe, sp, kp, gt, _: _moe_combine(oe, (fe, sp, kp, gt),
                                                   x.dtype),
        (out_e, *meta, hg), ((None, rows, "embed"),) + (None,) * 5, (5,))
    y = constrain(y.reshape(b, s, d), "batch", None, "embed")
    if cfg.n_shared_experts:
        y = y + (swiglu(h @ p["sh_gate"], h @ p["sh_up"]) @ p["sh_down"])
    # sharded serving: every rank routes alike (the router is replicated)
    # and holds every expert with its ff dim split, so the expert and
    # shared-expert outputs are partial sums: one reduce covers both.
    return x + constrain(psum_parts(y), "batch", None, "embed")


def _groups_follow_rows(h, G: int) -> bool:
    """Whether each shard of the rows of ``h`` (b, s, d) holds whole token
    groups of the G (the groups shard over the same mesh axes as the
    rows); True for a plain tensor."""
    if not is_dtensor(h):
        return True
    mesh = h.device_mesh
    g = spec_for(("moe_groups",), mesh, (G,))[0]
    return g is not None and g == spec_for(("batch",), mesh,
                                           (h.shape[0],))[0]
