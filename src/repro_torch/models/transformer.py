"""Decoder-LM assembly (port of ``models/transformer.py``).

Parameter declarations exist for every family, so every architecture's
tree can be built and counted.  ``forward`` runs the dense family in
modes ``train`` (forward only), ``prefill``, ``decode`` and ``chunk``;
the JAX package's scan over stacked layers is a Python loop here, each
layer reading its slice of the stacked parameters.

* ``train``   — full-sequence causal forward, logits everywhere.
* ``prefill`` — same compute; every layer also emits its K/V (a ring,
  rolled mask-aware, for sliding-window caches); returns (last-position
  logits, cache).
* ``decode``  — one token in; a dense slot cache or the page pools are
  written in place.
* ``chunk``   — a multi-token prefill chunk against the paged cache.

MoE, MLA, gemma3's local/global layers, ssm/hybrid, vlm and audio, and
the ``verify`` mode come with later slices and raise here.
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
    if cfg.family != "dense" or cfg.local_global_pattern:
        slice_ = ("the cache-layouts slice (gemma3 local/global layers)"
                  if cfg.local_global_pattern else
                  "the remaining-families slice")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): forward comes with {slice_}")


def cache_decls(cfg, batch: int, max_seq: int):
    """Dense slot caches: {"k", "v"} of (n_layers, batch, hkv, S, hd),
    bf16, or int8 plus bf16 {"k_scale", "v_scale"} of (n_layers, batch,
    hkv, S, 1) when ``cfg.kv_cache_dtype == "int8"``."""
    _check_forward_family(cfg)
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
    decode/chunk -> (logits, cache).

    ``last_pos`` (prefill/chunk): (b,) index of the true last token; the
    returned logits are gathered there.  Paged serving: pass
    ``cache={"pages": pools, "block_tab": bt}`` with pools and tables
    keyed by page group ({"kv"}).  ``pos`` (decode/chunk) is a (b,)
    position tensor, one position per row; dense decode also takes a host
    int for every row.  ``cache_offset`` (chunk mode): (b,) position
    below which the cache is read-only.  The pools or the dense cache
    passed in are updated in place and returned."""
    if mode not in ("train", "prefill", "decode", "chunk"):
        raise NotImplementedError(
            f"mode {mode!r} comes with the speculative-decode slice")
    dtype = torch_dtype(cfg.dtype)
    params = tree_map(
        lambda _, p: p.to(dtype) if p.dtype.is_floating_point
        and p.dtype != dtype else p, params)
    x = _embed_input(cfg, params, batch)
    b, s, _ = x.shape

    block_tab = pools = None
    if isinstance(cache, dict) and "block_tab" in cache:
        block_tab, pools = cache["block_tab"]["kv"], cache["pages"]["kv"]
    if mode == "chunk" and block_tab is None:
        raise NotImplementedError("chunk mode requires a paged cache")
    write_idx = None
    if block_tab is not None:
        n_pages, _, page, _ = pools["k"].shape[1:]
        write_idx = L.paged_write_index(
            block_tab, pos, s, page, n_pages,
            last_pos if mode == "chunk" else None,
            cache_offset if mode == "chunk" else None)

    w, theta = cfg.sliding_window, cfg.rope_theta
    cl = min(cache_len, w) if (w and cache_len) else cache_len
    emitted = []
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = _tree_idx(blocks, i)
        if block_tab is not None and mode in ("decode", "chunk"):
            x, _ = L.attention_apply_paged(
                cfg, p["attn"], x, window=w, theta=theta,
                pages={n: a[i] for n, a in pools.items()},
                block_tab=block_tab, pos=pos,
                last_idx=last_pos if mode == "chunk" else None,
                cache_offset=cache_offset if mode == "chunk" else None,
                write_idx=write_idx)
        elif mode == "decode":
            x, _ = L.attention_apply(
                cfg, p["attn"], x, window=w, theta=theta,
                cache={n: c[i] for n, c in cache.items()}, pos=pos)
        else:
            x_in = x
            x, _ = L.attention_apply(cfg, p["attn"], x, window=w, theta=theta)
            if mode == "prefill":
                emitted.append(_prefill_kv(cfg, p["attn"], x_in, w, theta,
                                           cl, last_pos))
        x = L.mlp_apply(cfg, p["mlp"], x)

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
        return logits, {n: torch.stack([c[n] for c in emitted])
                        for n in emitted[0]}
    if block_tab is not None:
        return logits, {"kv": pools}
    return logits, cache

