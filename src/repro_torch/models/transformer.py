"""Decoder-LM assembly (port of ``models/transformer.py``).

Parameter declarations exist for every family, so every architecture's
tree can be built and counted.  ``forward`` runs the dense family in
modes ``train`` (forward only), ``prefill``, ``decode`` and ``chunk``,
and the recurrent families -- ``ssm`` (mamba2) and ``hybrid`` (zamba2:
Mamba2 layers with one shared attention+MLP block after every
``shared_attn_every`` of them) -- in modes ``train``, ``prefill`` and
``decode``; the JAX package's scan over stacked layers is a Python loop
here, each layer reading its slice of the stacked parameters.

* ``train``   — full-sequence causal forward, logits everywhere.
* ``prefill`` — same compute; every layer also emits its K/V (a ring,
  rolled mask-aware, for sliding-window caches); returns (last-position
  logits, cache).
* ``decode``  — one token in; a dense slot cache or the page pools are
  written in place.
* ``chunk``   — a multi-token prefill chunk against the paged cache.
* ``verify``  — a speculative-decode span against the paged cache: k
  tokens scored like k sequential decode steps, full (b, k, Vp) logits.

Recurrent caches are slot-dense (nothing to page): ssm's is {"conv",
"ssd"} stacked over the layers, hybrid's {"ssm": that, "attn": the
shared block's K/V stacked over its application sites}; every leaf has
its slot axis at 1.  MoE, MLA, gemma3's local/global layers, vlm and
audio come with later slices and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import layers as L
from . import ssm as S
from .params import Decl, stack_decls, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _tree_idx(tree, i):
    return tree_map(lambda _, a: a[i], tree)


# --- parameter declarations, every family ---------------------------------------------


def dense_blocks(cfg) -> Dict[str, Any]:
    Ln = cfg.n_layers
    return {"attn": L.attention_decls(cfg, (Ln,)),
            "mlp": L.mlp_decls(cfg, (Ln,))}


def _block_decls(cfg) -> Dict[str, Any]:
    if cfg.local_global_pattern:                      # gemma3
        G, per = cfg.group_layout
        return {"attn": L.attention_decls(cfg, (G, per)),
                "mlp": L.mlp_decls(cfg, (G, per))}
    Ln = cfg.n_layers
    if cfg.family == "moe" and cfg.mla:               # deepseek
        Ld, Lr = cfg.first_dense_layers, cfg.n_layers - cfg.first_dense_layers
        return {"first": {"attn": L.mla_decls(cfg, (Ld,)),
                          "mlp": L.mlp_decls(cfg, (Ld,), d_ff=cfg.d_ff)},
                "rest": {"attn": L.mla_decls(cfg, (Lr,)),
                         "moe": L.moe_decls(cfg, (Lr,))}}
    if cfg.family == "moe":
        return {"attn": L.attention_decls(cfg, (Ln,)),
                "moe": L.moe_decls(cfg, (Ln,))}
    if cfg.family == "ssm":
        return {"ssm": S.mamba2_decls(cfg, (Ln,))}
    if cfg.family == "hybrid":                        # zamba2
        k = cfg.shared_attn_every
        G = cfg.n_layers // k
        tail = cfg.n_layers - G * k
        decls = {"ssm_groups": S.mamba2_decls(cfg, (G, k)),
                 "shared_attn": L.attention_decls(cfg, ()),
                 "shared_mlp": L.mlp_decls(cfg, ())}
        if tail:
            decls["ssm_tail"] = S.mamba2_decls(cfg, (tail,))
        return decls
    if cfg.family == "audio":                         # musicgen
        d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        cross = {
            "norm": Decl((Ln, d), ("stack", "embed"), init="zeros"),
            "wq": Decl((Ln, d, hq * hd), ("stack", "embed", "heads")),
            "wk": Decl((Ln, d, hq * hd), ("stack", "embed", "heads")),
            "wv": Decl((Ln, d, hq * hd), ("stack", "embed", "heads")),
            "wo": Decl((Ln, hq * hd, d), ("stack", "heads", "embed")),
        }
        return {"attn": L.attention_decls(cfg, (Ln,)), "cross": cross,
                "mlp": L.mlp_decls(cfg, (Ln,))}
    return dense_blocks(cfg)                          # dense, vlm


def model_decls(cfg) -> Dict[str, Any]:
    d, Vp = cfg.d_model, cfg.padded_vocab
    decls: Dict[str, Any] = {
        "final_norm": Decl((d,), ("embed",), init="zeros"),
    }
    if cfg.family == "audio":
        decls["embed"] = Decl((cfg.n_codebooks, Vp, d),
                              ("codebooks", "vocab", "embed"),
                              std=cfg.embed_std)
        decls["unembed"] = Decl((cfg.n_codebooks, d, Vp),
                                ("codebooks", "embed", "vocab"))
    else:
        decls["embed"] = Decl((Vp, d), ("vocab", "embed"), std=cfg.embed_std)
        decls["unembed"] = Decl((d, Vp), ("embed", "vocab"))
    if cfg.family == "vlm":
        decls["vis_proj"] = Decl((cfg.vision_dim, d), (None, "embed"))
    decls["blocks"] = _block_decls(cfg)
    return decls


def _check_forward_family(cfg) -> None:
    if cfg.family not in ("dense", "ssm", "hybrid") \
            or cfg.local_global_pattern:
        slice_ = ("the cache-layouts slice (gemma3 local/global layers)"
                  if cfg.local_global_pattern else
                  "the remaining-families slice")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): forward comes with {slice_}")


def _n_shared(cfg) -> int:
    """Application sites of zamba2's shared block (one per full group)."""
    return cfg.n_layers // cfg.shared_attn_every


def cache_decls(cfg, batch: int, max_seq: int):
    """Dense slot caches: {"k", "v"} of (n_layers, batch, hkv, S, hd),
    bf16, or int8 plus bf16 {"k_scale", "v_scale"} of (n_layers, batch,
    hkv, S, 1) when ``cfg.kv_cache_dtype == "int8"``.  ssm: {"conv"
    (n_layers, batch, K-1, C), "ssd" (n_layers, batch, h, ds, hd)}, fp32;
    hybrid: {"ssm": those, "attn": the K/V leaves stacked over the shared
    block's application sites}."""
    _check_forward_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        ssm = stack_decls(S.mamba2_cache_decl(cfg, batch), cfg.n_layers)
        if cfg.family == "ssm":
            return ssm
        attn = L.attention_cache_decl(cfg, batch, max_seq, None)
        return {"ssm": ssm, "attn": stack_decls(attn, _n_shared(cfg))}
    base = L.attention_cache_decl(cfg, batch, max_seq, cfg.sliding_window)
    return stack_decls(base, cfg.n_layers)


def paged_supported(cfg) -> bool:
    """True iff the family has a pageable cache layout."""
    from .cache_layouts import get_layout
    return get_layout(cfg, cfg.kv_page_size or 16) is not None


def paged_cache_decls(cfg, n_pages, page_size: int):
    """Per-group, per-layer shared page pools, stacked over layers —
    (n_layers, n_pages, hkv, page_size, head_dim) per k/v leaf.
    ``n_pages``: int or {group_name: int}."""
    from .cache_layouts import get_layout
    layout = get_layout(cfg, page_size)
    if layout is None:
        raise NotImplementedError(
            f"paged KV unsupported for {cfg.name} ({cfg.family}); "
            "use dense slot caches")
    if not isinstance(n_pages, dict):
        n_pages = {g.name: int(n_pages) for g in layout.groups}
    return layout.pool_decls(n_pages)


# --- forward -------------------------------------------------------------------------


def _embed_input(cfg, params, batch) -> torch.Tensor:
    _check_forward_family(cfg)
    x = params["embed"][batch["tokens"]]
    return x.to(torch_dtype(cfg.dtype))


def _prefill_kv(cfg, p, x, window, theta, cache_len, last_pos):
    """The K/V a prefill emits into a dense cache (recomputed from the
    block input, as the reference does)."""
    b, s, _ = x.shape
    h = L.rmsnorm(x, p["norm"])
    _, k, v = L._qkv(cfg, p, h)
    k = L.rope(k, torch.arange(s, device=x.device), theta).transpose(1, 2)
    v = v.transpose(1, 2)                              # (b, hkv, s, hd)
    Sc = cache_len or s
    if window is not None and Sc == window:
        # Mask-aware ring emission: slot j holds the key of the LAST true
        # position p <= last_pos with p % w == j.
        last = (last_pos.to(torch.int64) if last_pos is not None
                else torch.full((b,), s - 1, dtype=torch.int64,
                                device=x.device))
        j = torch.arange(window, device=x.device)
        pj = last[:, None] - ((last[:, None] - j[None, :]) % window)
        idx = pj.clamp(0, s - 1)[:, None, :, None].expand(
            b, k.shape[1], window, k.shape[3])
        k = torch.gather(k, 2, idx)
        v = torch.gather(v, 2, idx)
    elif Sc > s:
        pad = (0, 0, 0, Sc - s)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return L._to_cache(cfg, {"k": k, "v": v})


def forward(cfg, params, batch, mode: str = "train",
            cache: Optional[Any] = None, pos=None,
            cache_len: Optional[int] = None,
            last_pos: Optional[torch.Tensor] = None,
            cache_offset: Optional[torch.Tensor] = None):
    """train -> logits (b, s, Vp); prefill -> (last logits, cache);
    decode/chunk/verify -> (logits, cache).

    ``last_pos`` (prefill/chunk): (b,) index of the true last token; the
    returned logits are gathered there.  Paged serving: pass
    ``cache={"pages": pools, "block_tab": bt}`` with pools and tables
    keyed by page group ({"kv"}).  ``pos`` (decode/chunk) is a (b,)
    position tensor, one position per row; dense decode also takes a host
    int for every row.  ``cache_offset`` (chunk mode): (b,) position
    below which the cache is read-only.  The pools or the dense cache
    passed in are updated in place and returned.

    ``mode="verify"`` (speculative decode): tokens (b, k) at positions
    pos..pos+k-1 against the paged cache, like a batched k-token decode
    step, returning FULL (b, k, Vp) logits (no last-position gather) so
    the caller scores every span position in one call.  The span's own
    K/V is read pool-rounded, as sequential decode would read it."""
    if mode not in ("train", "prefill", "decode", "chunk", "verify"):
        raise NotImplementedError(f"unknown forward mode {mode!r}")
    dtype = torch_dtype(cfg.dtype)
    params = tree_map(
        lambda _, p: p.to(dtype) if p.dtype.is_floating_point
        and p.dtype != dtype else p, params)
    x = _embed_input(cfg, params, batch)
    b, s, _ = x.shape

    block_tab = pools = None
    if isinstance(cache, dict) and "block_tab" in cache:
        block_tab, pools = cache["block_tab"]["kv"], cache["pages"]["kv"]
    if mode in ("chunk", "verify") and block_tab is None:
        raise NotImplementedError(f"{mode} mode requires a paged cache")
    write_idx = None
    if block_tab is not None:
        n_pages, hkv, page, _ = pools["k"].shape[1:]
        chunk_masks = ((last_pos, cache_offset) if mode == "chunk"
                       else (None, None))
        write_idx = L.paged_store_rows(
            block_tab, pos, s, page, n_pages, hkv, *chunk_masks) \
            if cfg.kv_cache_dtype == "int8" else L.paged_write_index(
                block_tab, pos, s, page, n_pages, *chunk_masks)

    w, theta = cfg.sliding_window, cfg.rope_theta
    cl = min(cache_len, w) if (w and cache_len) else cache_len
    blocks = params["blocks"]
    store_rows = None
    if mode == "decode" and block_tab is None \
            and cfg.kv_cache_dtype == "int8" and "k" in cache:
        # an int8 dense step writes the same rows in every layer.
        _, _, hkv, S, _ = cache["k"].shape
        store_rows = L.dense_store_rows(L.decode_pos(pos, b, x.device), S,
                                        hkv, w)
    if cfg.family in ("ssm", "hybrid"):
        x, new_cache = _recurrent_layers(cfg, blocks, x, mode, cache, pos,
                                         cache_len, last_pos)
    else:
        emitted = []
        for i in range(cfg.n_layers):
            p = _tree_idx(blocks, i)
            if block_tab is not None and mode in ("decode", "chunk",
                                                  "verify"):
                x, _ = L.attention_apply_paged(
                    cfg, p["attn"], x, window=w, theta=theta,
                    pages={n: a[i] for n, a in pools.items()},
                    block_tab=block_tab, pos=pos,
                    last_idx=last_pos if mode == "chunk" else None,
                    cache_offset=cache_offset if mode == "chunk" else None,
                    verify=mode == "verify", write_idx=write_idx)
            else:
                x = _attn_dense(cfg, p["attn"], x, mode, cache, i, pos, w,
                                theta, cl, last_pos, emitted, store_rows)
            x = L.mlp_apply(cfg, p["mlp"], x)
        new_cache = _stack_emitted(emitted) if mode == "prefill" else None

    x = L.rmsnorm(x, params["final_norm"])
    if mode in ("prefill", "chunk"):
        if last_pos is not None:
            idx = last_pos.to(torch.int64)[:, None, None].expand(
                b, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        else:
            x = x[:, -1:]
    logits = x @ params["unembed"]
    if mode == "train":
        return logits
    if mode == "prefill":
        return logits, new_cache
    if block_tab is not None:
        return logits, {"kv": pools}
    return logits, cache


def _stack_emitted(emitted):
    """Per-layer cache dicts -> one dict of leaves stacked over layers."""
    return {n: torch.stack([c[n] for c in emitted]) for n in emitted[0]}


def _attn_dense(cfg, p, x, mode, cache, i, pos, window, theta, cache_len,
                last_pos, emitted, store_rows=None):
    """One attention block without pages: decode against layer ``i`` of
    the dense slot ``cache`` (written in place; an int8 cache at
    ``store_rows``), or the full-sequence forward, which in prefill also
    appends its K/V to ``emitted``."""
    if mode == "decode":
        x, _ = L.attention_apply(cfg, p, x, window=window, theta=theta,
                                 cache={n: c[i] for n, c in cache.items()},
                                 pos=pos, store_rows=store_rows)
        return x
    x_in = x
    x, _ = L.attention_apply(cfg, p, x, window=window, theta=theta)
    if mode == "prefill":
        emitted.append(_prefill_kv(cfg, p, x_in, window, theta, cache_len,
                                   last_pos))
    return x


def _recurrent_layers(cfg, blocks, x, mode, cache, pos, cache_len,
                      last_pos):
    """The ssm and hybrid stacks: the Mamba2 layers in order; for hybrid,
    after each full group of ``shared_attn_every`` of them the shared
    attention+MLP block (one set of weights, its own K/V cache at each
    application site), then the Mamba-only tail.  Returns (x, the cache
    a prefill emits, else None)."""
    hybrid = cfg.family == "hybrid"
    k = cfg.shared_attn_every if hybrid else cfg.n_layers
    G = _n_shared(cfg) if hybrid else 0
    ssm_cache = (cache["ssm"] if hybrid else cache) if mode == "decode" \
        else None
    emitted_ssm, emitted_attn = [], []
    for li in range(cfg.n_layers):
        if not hybrid:
            p = _tree_idx(blocks["ssm"], li)
        elif li < G * k:
            p = _tree_idx(_tree_idx(blocks["ssm_groups"], li // k), li % k)
        else:
            p = _tree_idx(blocks["ssm_tail"], li - G * k)
        if mode == "decode":
            x, _ = S.mamba2_apply(cfg, p, x, cache={
                n: c[li] for n, c in ssm_cache.items()})
        else:
            x, c = S.mamba2_apply(cfg, p, x, emit_cache=mode == "prefill")
            if c is not None:
                emitted_ssm.append(c)
        if hybrid and li < G * k and (li + 1) % k == 0:
            x = _attn_dense(cfg, blocks["shared_attn"], x, mode,
                            cache["attn"] if mode == "decode" else None,
                            li // k, pos, None, cfg.rope_theta, cache_len,
                            last_pos, emitted_attn)
            x = L.mlp_apply(cfg, blocks["shared_mlp"], x)
    if mode != "prefill":
        return x, None
    ssm = _stack_emitted(emitted_ssm)
    return x, ({"ssm": ssm, "attn": _stack_emitted(emitted_attn)}
               if hybrid else ssm)

