"""Serving steps (port of ``serve/serve_loop.py``).

* ``make_sampling_serve_steps`` — prefill/decode over dense slot caches
  that sample on the device (argmax at temperature 0, else a categorical
  of ``logits / T``) and return int32 token ids; ``greedy_generate``
  drives it and, at temperature 0, is the port's dense oracle for both
  batcher modes.
* ``make_paged_decode_step`` — ONE batched call advances every slot of
  the continuous batcher over the page pools.
* ``make_chunk_prefill_step`` — one prompt chunk for one slot against the
  page pools; the final chunk installs the slot's decode state.
* ``make_spec_verify_step`` — one speculative verify span for every slot:
  scratch page copies, the block-table swap, the span forward, greedy
  agreement and the commit, in one call.

The JAX steps are jitted with their pools donated; here they run eagerly
and update the pools and slot-state tensors in place.  Pools and block
tables are dicts keyed by the layout's page groups ({"kv"}, gemma3's
{"local", "global"}, or MLA's {"latent"}, whose pools nest).  The batcher's steps decode greedily, as the
reference's do.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import registry
from ..models.cache_layouts import get_layout
from ..models.params import params_from_numpy, tree_leaves


def _sample_last(logits_last: torch.Tensor,
                 generator: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    """On-device sampling of the last position's logits (b, Vp) -> (b,)
    int32, or (b, K, Vp) -> (b, K) for audio's codebooks.  Temperature 0:
    argmax (``generator`` unused).  Above 0: a categorical of ``logits /
    T`` over all ``Vp`` columns, one uniform per logit, drawn as
    ``jax.random.categorical`` draws it (Gumbel-max: the argmax of
    ``logits / T + g`` with ``g = -log(-log(u))``, ``u`` uniform on
    ``[tiny, 1)``), the uniforms from ``generator`` on the logits'
    device.  No host read."""
    if temperature > 0:
        u = torch.rand(logits_last.shape, generator=generator,
                       device=logits_last.device, dtype=torch.float32)
        g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits_last.float() / temperature + g,
                            -1).to(torch.int32)
    return torch.argmax(logits_last, -1).to(torch.int32)


def make_sampling_serve_steps(cfg: ModelConfig, max_seq: int,
                              temperature: float = 0.0):
    """Sample-in-step functions over dense slot caches:

    * ``prefill(params, batch_in, last_pos, generator=None)`` ->
      (tokens, cache)
    * ``decode(params, cache, tokens, pos, generator=None)`` ->
      (tokens, cache)

    Both return int32 token ids of shape (b,), or (b, K) for audio,
    sampled on the device by ``_sample_last`` at ``temperature`` (argmax
    at 0, where ``generator`` is unused).  Both pass their input dict
    through whole: ``patches`` (vlm) at prefill, ``cond`` (audio) at
    both.  ``decode`` writes the cache in place; ``pos`` is a (b,)
    position tensor (or a host int for every row)."""

    def prefill(params, batch_in, last_pos, generator=None):
        logits, cache = registry.forward(cfg, params, batch_in,
                                         mode="prefill", cache_len=max_seq,
                                         last_pos=last_pos)
        return _sample_last(logits[:, -1], generator, temperature), cache

    def decode(params, cache, tokens, pos, generator=None):
        logits, cache = registry.forward(cfg, params, dict(tokens),
                                         mode="decode", cache=cache, pos=pos)
        return _sample_last(logits[:, -1], generator, temperature), cache

    return prefill, decode


def advance_slots(logits, last_tok, pos, remaining, active, max_seq: int):
    """The decode step's slot-state update, shared by both batcher modes:
    greedy next token for active slots, positions and budgets advanced,
    ``finished`` = out of budget or at ``max_seq - 1``.  Returns
    ``(last_tok, pos, remaining, active, out)`` with ``out`` the
    (2, n_slots) int32 [next token, finished] rows."""
    nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
    nxt = torch.where(active, nxt, last_tok)
    pos = torch.where(active, pos + 1, pos)
    remaining = torch.where(active, remaining - 1, remaining)
    finished = active & ((remaining <= 0) | (pos >= max_seq - 1))
    active = active & ~finished
    out = torch.stack([nxt, finished.to(torch.int32)])   # (2, n_slots)
    return nxt, pos, remaining, active, out


def make_paged_decode_step(cfg: ModelConfig, max_seq: int, page_size: int):
    """Batched decode over paged KV: advances all slots at once.

    ``step(params, pools, block_tab, last_tok, pos, remaining, active)``
    returns ``(pools, last_tok, pos, remaining, active, out)`` with
    ``out`` the (2, n_slots) int32 [next token, finished] rows.  Inactive
    slots read through a table row of the invalid page id, so their
    writes are masked out and cannot touch pages that were freed and
    handed to another request."""
    layout = get_layout(cfg, page_size)

    def step(params, pools, block_tab, last_tok, pos, remaining, active):
        bt = {}
        for g in layout.groups:
            n_pages = tree_leaves(pools[g.name])[0].shape[
                layout.page_axis(g.name)]
            bt[g.name] = torch.where(active[:, None], block_tab[g.name],
                                     n_pages)
        cache = {"pages": pools, "block_tab": bt}
        logits, pools = registry.forward(
            cfg, params, {"tokens": last_tok[:, None].long()}, mode="decode",
            cache=cache, pos=pos)
        return (pools,) + advance_slots(logits, last_tok, pos, remaining,
                                        active, max_seq)

    return step


def _kept(idx: np.ndarray, bound: int, *others: np.ndarray):
    """The entries of padded host index arrays whose ``idx`` lies in
    ``[0, bound)``, as int64 arrays.  The reference pads with an
    out-of-range index that ``mode="drop"`` discards; torch indexing
    would raise (CPU) or device-assert (CUDA), so the padding is masked
    out on the host before any scatter."""
    idx = np.asarray(idx)
    keep = (idx >= 0) & (idx < bound)
    return [np.asarray(a)[keep].astype(np.int64) for a in (idx,) + others]


def make_spec_verify_step(cfg: ModelConfig, k: int, max_seq: int,
                          page_size: int):
    """Batched speculative *verify* step: one (n, k) forward scores a
    k-token span per slot in a single call.

    Row layout per slot: ``tokens[:, 0]`` is the last committed token
    (position ``pos``), ``tokens[:, 1:1+n_draft]`` the drafted tokens,
    the remaining columns padding (agreement-masked).  Greedy argmax of
    logits row i predicts position ``pos + i + 1``; the accepted length
    is the longest prefix of drafts agreeing with those predictions, and
    every verify commits at least one token (a row with ``n_draft == 0``
    commits exactly 1, plain decode), so one step serves mixed batches.
    The forward writes K/V for the whole span.

    ``fn(params, pools, block_tab, tokens, n_draft, pos, remaining,
    active, copy_src, copy_dst, swap_rows, swap_cols, swap_vals)``:
    ``tokens``/``n_draft`` on the device; the last five are per-group
    padded host arrays from the batcher's plan (copy padding points dst
    at ``n_pages``, swap padding points rows at ``n_slots``).  The old ->
    scratch page copies run in place on the pools; the swap is applied to
    a *copy* of the block table, so the batcher's own table is never
    touched by speculation (rollback is free; only commits scatter it
    afterwards).  Returns ``(pools, last_tok, pos, remaining, active,
    out)`` with ``out`` the (k + 2, n) int32 block the host reads: k
    prediction rows, the per-slot commit count and the finished flags."""
    layout = get_layout(cfg, page_size)

    def fn(params, pools, block_tab, tokens, n_draft, pos, remaining,
           active, copy_src, copy_dst, swap_rows, swap_cols, swap_vals):
        bt = {}
        for g in layout.groups:
            ax = layout.page_axis(g.name)
            n_pages = tree_leaves(pools[g.name])[0].shape[ax]
            dst, src = _kept(copy_dst[g.name], n_pages, copy_src[g.name])
            if len(dst):
                layout.copy_pages(pools, g.name, src.tolist(), dst.tolist())
            tab = block_tab[g.name].clone()
            rows, cols, vals = _kept(swap_rows[g.name], tab.shape[0],
                                     swap_cols[g.name], swap_vals[g.name])
            if len(rows):
                dev = tab.device
                tab[torch.from_numpy(rows).to(dev),
                    torch.from_numpy(cols).to(dev)] = torch.from_numpy(
                        vals).to(dev, tab.dtype)
            bt[g.name] = torch.where(active[:, None], tab, n_pages)
        cache = {"pages": pools, "block_tab": bt}
        logits, pools = registry.forward(
            cfg, params, {"tokens": tokens.long()}, mode="verify",
            cache=cache, pos=pos)
        preds = torch.argmax(logits, -1).to(torch.int32)       # (n, k)
        # drafts agree while they match the model's own greedy argmax.
        agree = (tokens[:, 1:] == preds[:, :-1]) & (
            torch.arange(k - 1, device=tokens.device)[None, :]
            < n_draft[:, None])
        acc = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1)
        commit = torch.minimum(torch.minimum(acc + 1, remaining),
                               (max_seq - 1 - pos).clamp(min=1))
        commit = torch.where(active, commit, 0).to(torch.int32)
        last = torch.gather(preds, 1,
                            (commit - 1).clamp(0, k - 1)[:, None].long())
        last_tok = torch.where(active, last[:, 0], tokens[:, 0])
        pos = pos + commit
        remaining = remaining - commit
        finished = active & ((remaining <= 0) | (pos >= max_seq - 1))
        active = active & ~finished
        out = torch.cat([preds.T, commit[None, :],
                         finished.to(torch.int32)[None, :]])
        return pools, last_tok, pos, remaining, active, out

    return fn


def make_chunk_prefill_step(cfg: ModelConfig, chunk: int, max_seq: int,
                            page_size: int):
    """Single-request prefill chunk against the paged cache.

    ``fn(params, pools, block_tab, last_tok, pos, remaining, active,
    tokens, pos0, last_in_chunk, slot_idx, is_final, plen, max_new,
    cache_offset)``: ``tokens`` is (1, chunk), ``pos0``/``last_in_chunk``
    are (1,) tensors, the rest host scalars.  Returns ``(pools, last_tok,
    pos, remaining, active, tok0)`` with ``tok0`` the greedy token after
    the chunk's last true position.  Only the final chunk writes the
    slot's decode state (the reference scatters every chunk and drops
    the non-final ones through the invalid slot id)."""
    layout = get_layout(cfg, page_size)

    def fn(params, pools, block_tab, last_tok, pos, remaining, active,
           tokens, pos0, last_in_chunk, slot_idx, is_final, plen, max_new,
           cache_offset):
        bt_row = {g.name: block_tab[g.name][slot_idx:slot_idx + 1]
                  for g in layout.groups}
        cache = {"pages": pools, "block_tab": bt_row}
        off = torch.full((1,), int(cache_offset), dtype=torch.int32,
                         device=tokens.device)
        logits, pools = registry.forward(
            cfg, params, {"tokens": tokens.long()}, mode="chunk",
            cache=cache, pos=pos0, last_pos=last_in_chunk, cache_offset=off)
        tok0 = torch.argmax(logits[0, -1], -1).to(torch.int32)
        if is_final:
            last_tok[slot_idx] = tok0
            pos[slot_idx] = plen
            remaining[slot_idx] = max_new - 1
            active[slot_idx] = bool(max_new > 1 and plen < max_seq - 1)
        return pools, last_tok, pos, remaining, active, tok0

    return fn


def greedy_generate(cfg: ModelConfig, params, prompt_batch: Dict,
                    steps: int, max_seq: int, temperature: float = 0.0,
                    seed: int = 0, *, device="cuda"):
    """Generation over dense slot caches: prefill the prompt batch, then
    ``steps`` decode steps, each token sampled on the device at
    ``temperature`` from one generator seeded with ``seed`` (greedy at
    0: the port's dense oracle).  ``prompt_batch`` holds numpy arrays
    (bf16 ones too) or tensors: "tokens" (b, s), or (b, s, K) for
    audio, and the family's inputs, "patches" (vlm; the prompt's
    positions count its ``vision_patches``) and "cond" (audio; passed to
    every decode step).  Returns an (b, steps) int32 numpy array, (b,
    steps, K) for audio."""
    batch = {k: v.to(device) if torch.is_tensor(v)
             else params_from_numpy(v, device)
             for k, v in prompt_batch.items()}
    tok = batch["tokens"] = batch["tokens"].long()
    b = tok.shape[0]
    prompt_len = tok.shape[1] + (cfg.vision_patches
                                 if cfg.family == "vlm" else 0)
    pre, dec = make_sampling_serve_steps(cfg, max_seq, temperature)
    gen = (torch.Generator(device=tok.device).manual_seed(seed)
           if temperature > 0 else None)
    last_pos = torch.full((b,), prompt_len - 1, dtype=torch.int64,
                          device=device)
    nxt, cache = pre(params, batch, last_pos, gen)
    extras = {k: v for k, v in batch.items() if k == "cond"}
    out = []
    pos = torch.full((b,), prompt_len, dtype=torch.int32, device=device)
    for _ in range(steps):
        tokens = nxt.reshape((b, 1) + nxt.shape[1:])
        out.append(tokens.cpu().numpy())
        nxt, cache = dec(params, cache, {"tokens": tokens.long(), **extras},
                         pos, gen)
        pos = pos + 1
    return np.concatenate(out, axis=1)
