"""Plain oracles for the attention, stencil and row-reduce kernels (port
of ``kernels/ref.py``).

Naive but obviously correct: the kernels and their plain twins are held
against these in tests.  Like the reference, they mask with -inf, so a
row with no valid key comes out NaN here while the kernels give 0 —
tests keep such rows out of comparisons with these oracles.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
