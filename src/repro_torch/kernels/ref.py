"""Plain oracles for the attention, SSD, stencil and row-reduce kernels
(port of ``kernels/ref.py``).

Naive but obviously correct: the kernels and their plain twins are held
against these in tests.  Like the reference, they mask with -inf, so a
row with no valid key comes out NaN here while the kernels give 0 —
tests keep such rows out of comparisons with these oracles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..roofline import count as _count

F32 = torch.float32


def attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None):
    """GQA attention oracle.  q: (b, hq, sq, d); k, v: (b, hkv, sk, d);
    queries aligned to the end of the kv sequence.  Computed in fp32."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qf = q.to(F32) * scale
    kf = k.to(F32).repeat_interleave(group, dim=1)
    vf = v.to(F32).repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    sk = k.shape[2]
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tab, pos,
                        window: Optional[int] = None,
                        page_base: Optional[torch.Tensor] = None,
                        k_scale_pages: Optional[torch.Tensor] = None,
                        v_scale_pages: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None):
    """Paged-KV decode attention oracle: gather every sequence's pages
    into a dense (b, hkv, n_blocks*page, d) view, then plain masked
    attention.  Shapes and options as ``flash_attention_decode_paged``."""
    b, hq, sq, d = q.shape
    n_pages, hkv, page, _ = k_pages.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    bt = block_tab.to(torch.int64).clamp(max=n_pages - 1)
    kd = k_pages[bt].to(F32)                          # (b, nb, hkv, page, d)
    vd = v_pages[bt].to(F32)
    if k_scale_pages is not None:
        kd = kd * k_scale_pages[bt].to(F32)
        vd = vd * v_scale_pages[bt].to(F32)
    S = bt.shape[1] * page
    kd = kd.transpose(1, 2).reshape(b, hkv, S, d).repeat_interleave(group, 1)
    vd = vd.transpose(1, 2).reshape(b, hkv, S, d).repeat_interleave(group, 1)
    qf = q.to(F32) * scale
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kd)
    if page_base is not None:
        kpos = (page_base.to(torch.int64)[:, :, None]
                + torch.arange(page, device=q.device)).reshape(b, S)
    else:
        kpos = torch.arange(S, device=q.device).expand(b, S)
    qpos = pos.to(torch.int64)[:, None] + torch.arange(sq, device=q.device)
    mask = (kpos[:, None, :] <= qpos[:, :, None]) & (kpos >= 0)[:, None, :]
    if window is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vd).to(q.dtype)


# --- Mamba2 SSD ------------------------------------------------------------------


def ssd_recurrence_ref(x, dt, A, B, C, state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step SSD recurrence (the unarguable oracle).

    x: (s, h, dh), dt: (s, h), A: (h,) (negative), B, C: (s, ds)
    [ngroups = 1].  state: (h, ds, dh).  Returns (y (s, h, dh) in x's
    dtype, final fp32 state).

        S_t = exp(dt_t A) S_{t-1} + dt_t B_t (x) x_t;   y_t = C_t . S_t
    """
    s, h, dh = x.shape
    ds = B.shape[-1]
    S = (torch.zeros((h, ds, dh), dtype=F32, device=x.device)
         if state is None else state.to(F32))
    xf, dtf, Bf, Cf, Af = (t.to(F32) for t in (x, dt, B, C, A))
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[t] * Af)                        # (h,)
        S = S * decay[:, None, None] + torch.einsum(
            "h,s,hd->hsd", dtf[t], Bf[t], xf[t])
        ys.append(torch.einsum("s,hsd->hd", Cf[t], S))
    return torch.stack(ys).to(x.dtype), S


def _ssd_work(x, dt, A, B, C, chunk: int = 64, state=None):
    """(FLOPs, bytes) of ``ssd_chunked_batch``'s loop over its chunks of
    ``chunk`` for the roofline counter: per chunk its four products
    (C·Bᵀ, the intra-chunk mix, C·S, the state update) and the cumsum,
    each reading its operands and writing its result in fp32."""
    b, s, h, dh = x.shape
    ds, Q = B.shape[-1], chunk
    n = -(-s // Q)
    f4 = 4
    flops = 2.0 * b * Q * (Q * ds + h * Q * dh + ds * h * dh + ds * h * dh)
    xs, cs, st, qq = b * Q * h * dh, b * Q * ds, b * h * ds * dh, b * Q * Q
    nbytes = f4 * ((2 * cs + qq) + (qq * h + 2 * xs) + (cs + st + xs)
                   + (cs + xs + st) + 2 * b * Q * h)
    return n * flops, n * nbytes


def _ssd_backward_work(*args, **kwargs):
    """Each product of the loop twice in the backward."""
    return tuple(2 * w for w in _ssd_work(*args, **kwargs))


def _ssd_fake(x, dt, A, B, C, chunk: int = 64, state=None):
    b, s, h, dh = x.shape
    return x.new_empty((b, s, h, dh)), x.new_empty((b, h, B.shape[-1], dh),
                                                   dtype=F32)


@_count.by_formula(_ssd_work, fake=_ssd_fake, backward=_ssd_backward_work)
def ssd_chunked_batch(x, dt, A, B, C, chunk: int = 64,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (state-space duality, arXiv:2405.21060) over a batch:
    ``ssd_chunked_ref`` for every row of x (b, s, h, dh), dt (b, s, h),
    B, C (b, s, ds), state (b, h, ds, dh), at once (the reference vmaps
    it over the batch).  Within each chunk a quadratic "attention" term,
    across chunks the carried state.  Returns (y (b, s, h, dh) in x's
    dtype, final fp32 state (b, h, ds, dh))."""
    b, s, h, dh = x.shape
    ds = B.shape[-1]
    s_pad = -(-s // chunk) * chunk
    if s_pad != s:
        # zero-dt padding is an exact no-op for the recurrence: decay
        # exp(0 A) = 1 and the B (x) x term is zeroed, so the final state
        # is unchanged; padded outputs are sliced away below.
        pad = s_pad - s
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    n = s_pad // chunk
    S = (torch.zeros((b, h, ds, dh), dtype=F32, device=x.device)
         if state is None else state.to(F32))
    xf = x.to(F32).reshape(b, n, chunk, h, dh)
    dtf = dt.to(F32).reshape(b, n, chunk, h)
    Bf = B.to(F32).reshape(b, n, chunk, ds)
    Cf = C.to(F32).reshape(b, n, chunk, ds)
    Af = A.to(F32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for c in range(n):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af, dim=1)                   # (b, Q, h)
        # Intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (B_j.C_i) x_j;
        # above the diagonal exp may overflow, and is selected away.
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (b, Q, Q, h)
        L = torch.where(mask, torch.exp(diff), torch.zeros_like(diff))
        G = torch.einsum("bis,bjs->bij", Cc, Bc)              # (b, Q, Q)
        W = G[..., None] * L                                  # (b, Q, Q, h)
        y = torch.einsum("bijh,bjhd->bihd", W, dtc[..., None] * xc)
        # Inter-chunk: contribution of the carried state.
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bis,bhsd->bihd", Cc, S)
        # State update: S' = exp(cum[-1]) S
        #                    + sum_j exp(cum[-1] - cum_j) dt_j B_j (x) x_j
        wj = torch.exp(cum[:, -1:, :] - cum) * dtc            # (b, Q, h)
        S = S * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjs,bjhd->bhsd", Bc, wj[..., None] * xc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s_pad, h, dh)[:, :s]
    return y.to(x.dtype), S


def ssd_chunked_ref(x, dt, A, B, C, chunk: int = 64,
                    state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD of one sequence: x (s, h, dh), dt (s, h), B, C (s, ds),
    state (h, ds, dh).  Same signature and semantics as the recurrence;
    the matmul-rich form the kernel tiles and the model's plain path."""
    y, S = ssd_chunked_batch(x[None], dt[None], A, B[None], C[None], chunk,
                             None if state is None else state[None])
    return y[0], S[0]


# --- stencil (paper Listing 6) ---------------------------------------------------


def stencil2d_ref(x, iters: int = 1):
    """4-point average stencil with zero boundary, iterated ``iters``
    times (the iterative case is the paper's cyclic-dataflow motivation).
    Computed in x's dtype, summed north, south, west, east."""
    for _ in range(iters):
        xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
        x = 0.25 * (xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2]
                    + xp[1:-1, 2:])
    return x


# --- tree reduction --------------------------------------------------------------


def rowreduce_ref(x, op: str = "add"):
    """Reduce the last axis; oracle for the tree-reduce kernel."""
    if op == "add":
        return torch.sum(x, dim=-1)
    if op == "max":
        return torch.amax(x, dim=-1)
    raise ValueError(op)
