"""Decoder-LM assembly (port of ``models/transformer.py``).

Parameter declarations exist for every family, so every architecture's
tree can be built and counted.  ``forward`` runs the dense family in
modes ``train``, ``prefill``, ``decode``, ``chunk`` and
``verify`` -- gemma3 too: groups of ``local_global_pattern``
sliding-window layers (θ ``rope_theta``) and one global layer (θ
``rope_theta_global``), parameters stacked (G, per) -- and the recurrent
families -- ``ssm`` (mamba2) and ``hybrid`` (zamba2:
Mamba2 layers with one shared attention+MLP block after every
``shared_attn_every`` of them) -- in modes ``train``, ``prefill`` and
``decode``; the JAX package's scan over stacked layers is a Python loop
here, each layer reading its slice of the stacked parameters.

* ``train``   — full-sequence causal forward, logits everywhere;
  differentiable: attention through ``layers.attention_blocked`` (the
  blocked online softmax with a flash-style backward) and, when autograd
  records, each layer under ``cfg.remat`` (``_layer``).
* ``prefill`` — same compute; every layer also emits its K/V (a ring,
  rolled mask-aware, for sliding-window caches); returns (last-position
  logits, cache).
* ``decode``  — one token in; a dense slot cache or the page pools are
  written in place.
* ``chunk``   — a multi-token prefill chunk against the paged cache.
* ``verify``  — a speculative-decode span against the paged cache: k
  tokens scored like k sequential decode steps, full (b, k, Vp) logits.

gemma3's caches are split by kind, {"local": leaves of (G, n_local, ...),
"global": leaves of (G, per - n_local, ...)}: dense slot caches (the
local layers' cache is a rolled ring of ``sliding_window`` slots) with
the slot axis at 2, or page pools read through per-group block tables, the local
group a ring of pages.  Recurrent caches are slot-dense (nothing to
page): ssm's is {"conv", "ssd"} stacked over the layers, hybrid's
{"ssm": that, "attn": the shared block's K/V stacked over its
application sites}; every leaf has its slot axis at 1.

The moe family runs in every mode: phi3.5-moe's GQA attention with an
MoE block in place of the MLP, and deepseek's MLA attention over a
compressed latent cache, one dense-MLP layer ("first") then MLA + MoE
layers with shared experts ("rest"); its caches are {"first", "rest"} of
{"c_kv", "k_rope"} leaves (slot axis 1), its page pools the "latent"
group's.  ``row_capacity`` gives each batch row its own MoE capacity (the
dense-slot steps, where the reference vmaps a one-row forward).

vlm (paligemma) and audio (musicgen) run in modes ``train``, ``prefill``
and ``decode`` over dense slot caches (neither has a page layout, in the
reference either).  paligemma is the dense stack behind an input of
``vision_patches`` projected patch embeddings (``batch["patches"]``,
prefill and train) put before the text; musicgen's layers add a
cross-attention block over ``batch["cond"]`` (every mode, K/V projected
from it on every call) between self-attention and its ungated GELU MLP,
its tokens are (b, s, K) over ``n_codebooks`` and its logits (b, s, K,
Vp).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributed.sharding import constrain
from . import layers as L
from . import ssm as S
from .params import Decl, stack_decls, tree_leaves, tree_map

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


def _n_shared(cfg) -> int:
    """Application sites of zamba2's shared block (one per full group)."""
    return cfg.n_layers // cfg.shared_attn_every


def cache_decls(cfg, batch: int, max_seq: int):
    """Dense slot caches: {"k", "v"} of (n_layers, batch, hkv, S, hd),
    bf16, or int8 plus bf16 {"k_scale", "v_scale"} of (n_layers, batch,
    hkv, S, 1) when ``cfg.kv_cache_dtype == "int8"``.  deepseek (MLA):
    {"first", "rest"} of {"c_kv" (L, batch, max_seq, lora), "k_rope" (L,
    batch, max_seq, rope)}, bf16 whatever ``kv_cache_dtype``.  ssm: {"conv"
    (n_layers, batch, K-1, C), "ssd" (n_layers, batch, h, ds, hd)}, fp32;
    hybrid: {"ssm": those, "attn": the K/V leaves stacked over the shared
    block's application sites}; gemma3: {"local": (G, n_local, batch,
    hkv, min(max_seq, window), hd), "global": (G, per - n_local, batch,
    hkv, max_seq, hd)} per leaf; vlm and audio: the dense stack's."""
    if cfg.local_global_pattern:
        G, per = cfg.group_layout
        n_local, w = cfg.local_global_pattern, cfg.sliding_window
        loc = L.attention_cache_decl(cfg, batch, min(max_seq, w), w)
        glo = L.attention_cache_decl(cfg, batch, max_seq, None)
        return stack_decls({"local": stack_decls(loc, n_local),
                            "global": stack_decls(glo, per - n_local)}, G)
    if cfg.family == "moe" and cfg.mla:
        base = L.mla_cache_decl(cfg, batch, max_seq)
        Ld = cfg.first_dense_layers
        return {"first": stack_decls(base, Ld),
                "rest": stack_decls(base, cfg.n_layers - Ld)}
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
    (n_layers, n_pages, hkv, page_size, head_dim) per k/v leaf of the
    flat layout's "kv" group, (G, per_kind, n_pages, ...) for gemma3's
    "local" and "global", {"first", "rest"} of (L, n_pages, page_size,
    lora | rope) for MLA's "latent".  ``n_pages``: int or {group_name:
    int}."""
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
    dtype = torch_dtype(cfg.dtype)
    tok = batch["tokens"]
    if cfg.family == "audio":
        # (b, s, K): the codebooks' embeddings added in codebook order in
        # the model dtype, rounding after every add as the reference's
        # ``sum`` does.
        emb = params["embed"]                          # (K, Vp, d)
        x = emb[0][tok[..., 0]]
        for c in range(1, cfg.n_codebooks):
            x = x + emb[c][tok[..., c]]
        return x.to(dtype)
    # on a mesh the table is gathered over its vocab shards first:
    # DTensor's vocab-sharded lookup (a masked partial sum) has no
    # backward.
    x = constrain(params["embed"], None, "embed")[tok]
    if cfg.local_global_pattern or cfg.family == "vlm":
        # gemma scaling: the reference multiplies by an np.float32 scalar,
        # which promotes to float32, and rounds to the model dtype after.
        x = x.to(torch.float32) * float(np.float32(np.sqrt(cfg.d_model)))
    if cfg.family == "vlm" and "patches" in batch:
        # the projected patches go before the text, joined in float32.
        pre = batch["patches"].to(dtype) @ params["vis_proj"]
        x = torch.cat([pre.to(torch.float32), x.to(torch.float32)], dim=1)
    return x.to(dtype)


def _emit_kv(cfg, kv, window, cache_len, last_pos):
    """The K/V a prefill emits into a dense cache from the block's rotated
    {"k", "v"} (b, hkv, s, hd), as ``attention_apply`` returns them
    without a cache: padded to the cache length, or a ring for a
    sliding-window cache."""
    k, v = kv["k"], kv["v"]
    b, s = k.shape[0], k.shape[2]
    device = k.device
    Sc = cache_len or s
    if window is not None and Sc == window:
        # Mask-aware ring emission: slot j holds the key of the LAST true
        # position p <= last_pos with p % w == j.
        last = (last_pos.to(torch.int64) if last_pos is not None
                else torch.full((b,), s - 1, dtype=torch.int64,
                                device=device))
        j = torch.arange(window, device=device)
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
            cache_offset: Optional[torch.Tensor] = None,
            row_capacity: bool = False):
    """train -> logits (b, s, Vp); prefill -> (last logits, cache);
    decode/chunk/verify -> (logits, cache).  audio: tokens (b, s, K),
    logits (b, s, K, Vp), ``batch["cond"]`` in every mode; vlm:
    ``batch["patches"]`` (train, prefill) put before the text, so
    positions and ``last_pos`` count the patches.

    ``last_pos`` (prefill/chunk): (b,) index of the true last token; the
    returned logits are gathered there.  Paged serving: pass
    ``cache={"pages": pools, "block_tab": bt}`` with pools and tables
    keyed by page group ({"kv"}, gemma3's {"local", "global"}, MLA's
    {"latent"}).
    ``pos`` (decode/chunk) is a (b,) position tensor, one position per
    row; dense decode also takes a host int for every row.  ``cache_offset`` (chunk mode): (b,) position
    below which the cache is read-only.  The pools or the dense cache
    passed in are updated in place and returned.

    ``mode="verify"`` (speculative decode): tokens (b, k) at positions
    pos..pos+k-1 against the paged cache, like a batched k-token decode
    step, returning FULL (b, k, Vp) logits (no last-position gather) so
    the caller scores every span position in one call.  The span's own
    K/V is read pool-rounded, as sequential decode would read it.

    ``row_capacity``: every MoE layer gives each batch row its own
    capacity (``layers.moe_groups``), as the reference's dense-slot
    batcher gets by vmapping a one-row forward; otherwise the b·s tokens
    share it, as in the reference's batched paged steps."""
    if mode not in ("train", "prefill", "decode", "chunk", "verify"):
        raise NotImplementedError(f"unknown forward mode {mode!r}")
    dtype = torch_dtype(cfg.dtype)
    params = tree_map(
        lambda _, p: p.to(dtype) if p.dtype.is_floating_point
        and p.dtype != dtype else p, params)
    x = _embed_input(cfg, params, batch)
    x = constrain(x, "batch", None, "embed")
    b, s, _ = x.shape

    block_tab = pools = None
    if isinstance(cache, dict) and "block_tab" in cache:
        block_tab, pools = cache["block_tab"], cache["pages"]
    if mode in ("chunk", "verify") and block_tab is None:
        raise NotImplementedError(f"{mode} mode requires a paged cache")
    # the rows this forward writes: its mode, positions and chunk masks.
    span = dict(mode=mode, pos=pos,
                last_idx=last_pos if mode == "chunk" else None,
                cache_offset=cache_offset if mode == "chunk" else None)

    w, theta = cfg.sliding_window, cfg.rope_theta
    cl = min(cache_len, w) if (w and cache_len) else cache_len
    blocks = params["blocks"]
    cond = batch.get("cond")
    if cond is not None:
        cond = cond.to(dtype)
    if cfg.family in ("ssm", "hybrid"):
        x, new_cache = _recurrent_layers(cfg, blocks, x, mode, cache, pos,
                                         cache_len, last_pos)
    elif cfg.mla:
        x, new_cache = _mla_layers(cfg, blocks, x, mode, cache, pools,
                                   block_tab, span, cache_len, row_capacity)
    elif cfg.local_global_pattern:
        x, new_cache = _gemma3_layers(cfg, blocks, x, mode, cache, pools,
                                      block_tab, span, cache_len, last_pos)
    else:
        emitted = []
        if block_tab is not None:
            bt, pools_kv = block_tab["kv"], pools["kv"]
            write_idx = _write_index(cfg, bt, pools_kv, 1, x.shape[1],
                                     False, span)
        else:
            store_rows = _dense_store_rows(cfg, mode, cache, pos, b, w,
                                           x.device)

        def layer(x, p, i):
            if block_tab is not None:
                x = _attn_paged(cfg, p["attn"], x, w, theta,
                                {n: a[i] for n, a in pools_kv.items()}, bt,
                                False, write_idx, span)
            else:
                x = _attn_dense(cfg, p["attn"], x, mode, cache, i, pos, w,
                                theta, cl, last_pos, emitted, store_rows)
            if "cross" in p:                          # musicgen
                x = L.cross_attention_apply(cfg, p["cross"], x, cond)
            return _ffn(cfg, p, x, row_capacity)

        for i in range(cfg.n_layers):
            x = _layer(cfg, mode, layer, x, _tree_idx(blocks, i), i)
        new_cache = _stack_emitted(emitted) if mode == "prefill" else None

    x = L.rmsnorm(x, params["final_norm"])
    if mode in ("prefill", "chunk"):
        if last_pos is not None:
            idx = last_pos.to(torch.int64)[:, None, None].expand(
                b, 1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        else:
            x = x[:, -1:]
    if cfg.family == "audio":
        logits = torch.einsum("bsd,kdv->bskv", x, params["unembed"])
    else:
        logits = x @ params["unembed"]
    logits = constrain(logits, "batch", None, "vocab")
    if mode == "train":
        return logits
    if mode == "prefill":
        return logits, new_cache
    if block_tab is not None:
        return logits, pools
    return logits, cache


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the products with no batch
    dims (the reference's ``dots_with_no_batch_dims_saveable``: ``x @ W``
    runs as ``mm``/``addmm``), recompute everything else.  ``bmm`` has a
    batch dim: the attention's tile products and the MoE experts' are
    recomputed, as in the reference."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(cfg, mode, fn, x, p, *args):
    """One layer, ``fn(x, p, *args)``.  In train mode, when autograd
    records it (an input or a parameter requires grad), under
    ``cfg.remat``: ``"none"`` keeps every activation the backward needs,
    ``"full"`` keeps only the layer's inputs and recomputes the layer in
    the backward, ``"dots"`` keeps the matmul outputs as well
    (``_save_dots``).  Recomputation changes memory, never values."""
    if (mode != "train" or cfg.remat == "none"
            or not torch.is_grad_enabled()
            or not (x.requires_grad
                    or any(t.requires_grad for t in tree_leaves(p)))):
        return fn(x, p, *args)
    from torch.utils import checkpoint as ckpt
    if cfg.remat == "full":
        return ckpt.checkpoint(fn, x, p, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return ckpt.checkpoint(
            fn, x, p, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat {cfg.remat!r} (none | dots | full)")


def _ffn(cfg, p, x, row_capacity):
    """A layer's MLP, or its MoE block where it has one."""
    if "moe" in p:
        return L.moe_apply(cfg, p["moe"], x, row_capacity)
    return L.mlp_apply(cfg, p["mlp"], x)


def _mla_layers(cfg, blocks, x, mode, cache, pools, block_tab, span,
                cache_len, row_capacity):
    """deepseek's stack: the "first" layers (MLA + dense MLP), then the
    "rest" (MLA + MoE with shared experts), each layer reading its slice
    of its part's stacked parameters and caches.  Paged, every layer
    reads and writes its slice of the "latent" group's pools through the
    one block table (the rows it writes computed once per forward).
    Returns (x, the {"first", "rest"} cache a prefill emits, else
    None)."""
    pos = span["pos"]
    write_idx = None
    if block_tab is not None:
        bt, latent = block_tab["latent"], pools["latent"]
        n_pages, page = latent["first"]["c_kv"].shape[1:3]
        write_idx = L.paged_write_index(
            bt, pos, x.shape[1], page, n_pages, span["last_idx"],
            span["cache_offset"])
    emitted = {}

    def layer(x, p, part, i):
        if block_tab is not None:
            x, _ = L.mla_apply_paged(
                cfg, p["attn"], x,
                pages={n: a[i] for n, a in latent[part].items()},
                block_tab=bt, pos=pos, last_idx=span["last_idx"],
                cache_offset=span["cache_offset"],
                verify=mode == "verify", write_idx=write_idx)
        elif mode == "decode":
            x, _ = L.mla_apply(
                cfg, p["attn"], x, pos=pos,
                cache={n: c[i] for n, c in cache[part].items()})
        else:
            x, rows = L.mla_apply(cfg, p["attn"], x, train=mode == "train")
            if mode == "prefill":
                emitted[part].append(L.mla_emit_latent(rows, cache_len))
        return _ffn(cfg, p, x, row_capacity)

    for part in ("first", "rest"):
        emitted[part] = []
        stack = blocks[part]
        for i in range(tree_leaves(stack)[0].shape[0]):
            x = _layer(cfg, mode, layer, x, _tree_idx(stack, i), part, i)
    if mode != "prefill":
        return x, None
    return x, {part: _stack_emitted(layers)
               for part, layers in emitted.items()}


def _stack_emitted(emitted):
    """Per-layer cache dicts -> one dict of leaves stacked over layers."""
    return {n: torch.stack([c[n] for c in emitted]) for n in emitted[0]}


def _write_index(cfg, block_tab, pools, page_axis, s, ring, span):
    """Where a forward's K/V rows land in one page group's pools (the
    same rows in every layer of the group): ``paged_store_rows`` for an
    int8 pool, else ``paged_write_index``; ``page_axis`` is the index of
    the page axis of the group's stacked leaves."""
    n_pages, hkv, page, _ = pools["k"].shape[page_axis:]
    args = (block_tab, span["pos"], s, page, n_pages)
    masks = dict(last_idx=span["last_idx"],
                 cache_offset=span["cache_offset"], ring=ring)
    if cfg.kv_cache_dtype == "int8":
        return L.paged_store_rows(*args, hkv, **masks)
    return L.paged_write_index(*args, **masks)


def _dense_store_rows(cfg, mode, cache, pos, b, window, device):
    """An int8 dense decode step's store rows (the same in every layer of
    one cache leaf shape), or None."""
    if mode != "decode" or cfg.kv_cache_dtype != "int8":
        return None
    hkv, S = cache["k"].shape[-3:-1]
    return L.dense_store_rows(L.decode_pos(pos, b, device), S, hkv, window)


def _attn_paged(cfg, p, x, window, theta, pages, block_tab, ring,
                write_idx, span):
    """One attention block against a layer's page pools (written in
    place)."""
    x, _ = L.attention_apply_paged(
        cfg, p, x, window=window, theta=theta, pages=pages,
        block_tab=block_tab, pos=span["pos"], ring=ring,
        last_idx=span["last_idx"], cache_offset=span["cache_offset"],
        verify=span["mode"] == "verify", write_idx=write_idx)
    return x


def _gemma3_layers(cfg, blocks, x, mode, cache, pools, block_tab, span,
                   cache_len, last_pos):
    """gemma3's stack: G groups of ``local_global_pattern`` sliding-window
    layers then one global layer, each layer reading its (g, i) slice of
    the (G, per)-stacked parameters.  Local layers read the ring (a ring
    of pages when paged, the rolled window cache in dense slots), global
    layers the flat table or the full cache.  Returns (x, the cache a
    prefill emits, else None)."""
    G, per = cfg.group_layout
    n_local = cfg.local_global_pattern
    b, s, _ = x.shape
    kinds = {"local": (cfg.sliding_window, cfg.rope_theta),
             "global": (None, cfg.rope_theta_global)}
    write_idx, store_rows = {}, {}
    for kind, (window, _) in kinds.items():
        if block_tab is not None:
            write_idx[kind] = _write_index(
                cfg, block_tab[kind], pools[kind], 2, s, kind == "local",
                span)
        elif mode == "decode":
            store_rows[kind] = _dense_store_rows(
                cfg, mode, cache[kind], span["pos"], b, window, x.device)
    emitted = {"local": [], "global": []}

    def layer(x, p, g, i):
        kind, j = ("local", i) if i < n_local else ("global", i - n_local)
        window, theta = kinds[kind]
        if block_tab is not None:
            x = _attn_paged(cfg, p["attn"], x, window, theta,
                            {n: a[g, j] for n, a in pools[kind].items()},
                            block_tab[kind], kind == "local",
                            write_idx[kind], span)
        else:
            cl = (min(cache_len, window) if (window and cache_len)
                  else cache_len)
            ci = ({n: c[g] for n, c in cache[kind].items()}
                  if mode == "decode" else None)
            x = _attn_dense(cfg, p["attn"], x, mode, ci, j, span["pos"],
                            window, theta, cl, last_pos, emitted[kind],
                            store_rows.get(kind))
        return L.mlp_apply(cfg, p["mlp"], x)

    for g in range(G):
        for i in range(per):
            x = _layer(cfg, mode, layer, x,
                       _tree_idx(_tree_idx(blocks, g), i), g, i)
    if mode != "prefill":
        return x, None
    return x, {kind: {n: t.reshape((G, -1) + t.shape[1:])
                      for n, t in _stack_emitted(layers).items()}
               for kind, layers in emitted.items()}


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
    x, kv = L.attention_apply(cfg, p, x, window=window, theta=theta,
                              train=mode == "train")
    if mode == "prefill":
        emitted.append(_emit_kv(cfg, kv, window, cache_len, last_pos))
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

    def layer(x, p, shared, li):
        if mode == "decode":
            x, _ = S.mamba2_apply(cfg, p, x, cache={
                n: c[li] for n, c in ssm_cache.items()})
        else:
            x, c = S.mamba2_apply(cfg, p, x, emit_cache=mode == "prefill")
            if c is not None:
                emitted_ssm.append(c)
        if shared is not None:
            x = _attn_dense(cfg, shared["attn"], x, mode,
                            cache["attn"] if mode == "decode" else None,
                            li // k, pos, None, cfg.rope_theta, cache_len,
                            last_pos, emitted_attn)
            x = L.mlp_apply(cfg, shared["mlp"], x)
        return x

    for li in range(cfg.n_layers):
        if not hybrid:
            p = _tree_idx(blocks["ssm"], li)
        elif li < G * k:
            p = _tree_idx(_tree_idx(blocks["ssm_groups"], li // k), li % k)
        else:
            p = _tree_idx(blocks["ssm_tail"], li - G * k)
        shared = None
        if hybrid and li < G * k and (li + 1) % k == 0:
            shared = {"attn": blocks["shared_attn"],
                      "mlp": blocks["shared_mlp"]}
        x = _layer(cfg, mode, layer, x, p, shared, li)
    if mode != "prefill":
        return x, None
    ssm = _stack_emitted(emitted_ssm)
    return x, ({"ssm": ssm, "attn": _stack_emitted(emitted_attn)}
               if hybrid else ssm)

