"""Serving steps (port of ``serve/serve_loop.py``).

* ``make_serve_steps`` — the raw-logits prefill and dense decode the
  dry-run counts for the ``prefill_*`` / ``decode_*`` / ``long_*``
  cells, with the dense slot cache as abstract tensors, on one device
  or on a ``DeviceMesh`` (DTensors, as ``train_loop.make_train_step``).
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

Sharded serving (``cfg.mesh_shape``, every paged family): each rank is
one process with its own batcher, holding plain tensors of its tiles of
the parameters and pools (``paged_sharding_specs``, ``cut_tiles``), and
the three paged steps run the per-shard model under a shard-local config
inside ``sharding.manual_axis`` of the model group (``_shard_wrap``), so
the model's ``psum_parts`` / ``gather_parts`` are collectives there and
the identity everywhere else.

The JAX steps are jitted with their pools donated; here they run eagerly
and update the pools and slot-state tensors in place.  Pools and block
tables are dicts keyed by the layout's page groups ({"kv"}, gemma3's
{"local", "global"}, or MLA's {"latent"}, whose pools nest).  The batcher's steps decode greedily, as the
reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed import sharding
from ..models import params as PP
from ..models import registry
from ..models.cache_layouts import get_layout
from ..models.params import (Decl, abstract_params, param_specs,
                             params_from_numpy, tree_at, tree_leaves,
                             tree_map)


def make_serve_steps(cfg: ModelConfig, batch: int, max_seq: int,
                     mesh=None, fake_mode=None):
    """(prefill, decode, abstract cache, shardings), as the reference's
    ``make_serve_steps`` returns them:

    * ``prefill(params, batch_in)`` -> (last-position logits, cache)
    * ``decode(params, cache, tokens, pos)`` -> (logits, cache), the
      cache written in place

    The abstract cache is ``cache_decls(cfg, batch, max_seq)`` without
    storage (fake tensors made in ``fake_mode``, else ``meta``).  With no
    mesh the shardings are None.  On a ``DeviceMesh`` they are
    ``(param shardings, cache shardings)``: parameters placed by
    ``registry.decls``' specs and the dense cache by
    ``registry.cache_decls``' (the sequence dim split where the decl
    names ``kv_seq`` or ``seq_sharded`` and the mesh axis divides it);
    the steps take parameters and cache as DTensors so placed (a plain
    tensor is placed on the way in) and a batch whose rows split over
    ("pod", "data") only where they divide, as the reference's
    ``in_shardings``.  Prefill's cache comes out in the cache's
    placements and its logits, like decode's, with their rows so split
    and the vocab whole.  The same code runs on gloo or NCCL ranks and on
    the ``fake`` backend the dry-run counts on."""
    cache_d = registry.cache_decls(cfg, batch, max_seq)
    ab_cache = abstract_params(cache_d, fake_mode)
    if mesh is None:
        def prefill(params, batch_in):
            return registry.forward(cfg, params, batch_in, mode="prefill",
                                    cache_len=max_seq)

        def decode(params, cache, tokens, pos):
            return registry.forward(cfg, params, dict(tokens),
                                    mode="decode", cache=cache, pos=pos)

        return prefill, decode, ab_cache, None

    def shard(_, spec):
        return sharding.Sharding(mesh, spec)
    p_sh = tree_map(shard, param_specs(registry.decls(cfg), mesh))
    c_sh = tree_map(shard, param_specs(cache_d, mesh))
    bspec = batch_spec(mesh, batch)

    def rows(x):
        """A batch leaf or logits: rows over the batch axes, the rest
        whole."""
        return sharding.Sharding(
            mesh, sharding.P(*bspec, *([None] * (x.dim() - 1)))).place(x)

    def prefill(params, batch_in):
        logits, cache = registry.forward(
            cfg, sharding.place_tree(params, p_sh),
            {k: rows(v) for k, v in batch_in.items()}, mode="prefill",
            cache_len=max_seq)
        return rows(logits), sharding.place_tree(cache, c_sh)

    def decode(params, cache, tokens, pos):
        logits, cache = registry.forward(
            cfg, sharding.place_tree(params, p_sh),
            {k: rows(v) for k, v in dict(tokens).items()}, mode="decode",
            cache=sharding.place_tree(cache, c_sh), pos=pos)
        return rows(logits), cache

    return prefill, decode, ab_cache, (p_sh, c_sh)


def batch_spec(mesh, batch: int):
    """The serve steps' batch spec on ``mesh``: rows over ("pod", "data"),
    each axis only where the rows still divide (the reference's
    ``make_serve_steps``), one entry."""
    axes, n = [], 1
    for a in ("pod", "data"):
        size = sharding.mesh_shape(mesh).get(a)
        if size and batch % (n * size) == 0:
            axes.append(a)
            n *= size
    return sharding.P(tuple(axes) if len(axes) > 1
                      else (axes[0] if axes else None))


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


# --- mesh-sharded paged serving (tensor parallelism over a process group) ------------
#
# The reference puts the paged step bodies under ``jax.shard_map``; here
# every rank is a process of its own (SPMD), holding plain tensors of its
# tiles.  Parameters and KV page pools split over the LAST mesh axis
# (cfg.tp_axis) by the rules' table, block tables and slot state are
# replicated, and the step body runs the per-shard model on a shard-local
# config with explicit collectives at the attention / FF output
# projections, MLA's latent read and the logits.  The sharded matmuls
# split output columns only (contraction dims are never split), partial
# sums add in group-rank order on every rank, and gathers are concats.

_MESHES: Dict[tuple, tuple] = {}


def serving_mesh_for(cfg: ModelConfig):
    """(mesh, tp_axis) of the sharded paged path over the default process
    group, made once per (shape, axis, process group); (None, None) when
    ``cfg.mesh_shape`` is empty (one process).  The mesh's device type
    follows the group's backend: cuda over NCCL, cpu over gloo (serving
    uses only the mesh's process groups, and gloo's collectives take the
    tensors where they lie)."""
    if not cfg.mesh_shape:
        return None, None
    sharding.validate_shardable(cfg, int(cfg.mesh_shape[-1]))
    import torch.distributed as dist
    from ..launch.mesh import serving_mesh
    world = dist.group.WORLD if dist.is_initialized() else None
    device_type = ("cuda" if world is not None
                   and dist.get_backend() == "nccl" else "cpu")
    key = (tuple(cfg.mesh_shape), cfg.tp_axis)
    hit = _MESHES.get(key)
    if hit is None or hit[0] is not world:
        _MESHES[key] = (world, serving_mesh(cfg.mesh_shape, cfg.tp_axis,
                                            device_type))
    return _MESHES[key][1], cfg.tp_axis


def serving_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """{axis: size} of ``cfg.mesh_shape``'s serving mesh ({} without
    one); specs reckoned from it need no process group."""
    if not cfg.mesh_shape:
        return {}
    from ..launch.mesh import serving_axes
    return dict(zip(serving_axes(cfg.mesh_shape, cfg.tp_axis),
                    (int(s) for s in cfg.mesh_shape)))


def shard_local_cfg(cfg: ModelConfig) -> ModelConfig:
    """The per-shard view of the model the step bodies run: the column-
    sharded dims (query and kv heads, ff, expert ff) divided by the tp
    extent, so every reshape in ``models.layers`` is shard-local.  MLA
    keeps the FULL kv_lora_rank (w_dkv and kv_norm stay replicated; only
    the latent pool splits, sliced at the cache write) and vocab_size
    stays full (the logits tile is gathered against padded_vocab).
    mesh_shape is cleared, so the local config never shards again."""
    t = int(cfg.mesh_shape[-1]) if cfg.mesh_shape else 1
    kw: Dict[str, Any] = {"mesh_shape": ()}
    if t > 1:
        kw["n_heads"] = cfg.n_heads // t
        kw["d_ff"] = cfg.d_ff // t
        if cfg.moe_d_ff:
            kw["moe_d_ff"] = cfg.moe_d_ff // t
        if not cfg.mla:
            kw["n_kv_heads"] = cfg.n_kv_heads // t
    return dataclasses.replace(cfg, **kw)


def paged_sharding_specs(cfg: ModelConfig, page_size: int, mesh=None):
    """(param_specs, pool_specs) of the sharded paged path, both from the
    rules' table with the serving overrides: parameters with ``experts
    -> None`` (the expert ff dims split over "model" instead, as the
    dense MLP's) and the token embedding replicated (a lookup by token id
    cannot read a vocab-split table; the unembed stays vocab-split);
    pools with ``lora -> "model"`` (``CacheLayout.pool_specs``).
    ``mesh``: a ``DeviceMesh`` or {axis: size}; None reckons the specs
    from ``cfg.mesh_shape``."""
    if mesh is None:
        mesh = serving_sizes(cfg)
    return (_param_tile_specs(cfg, mesh),
            get_layout(cfg, page_size).pool_specs(mesh))


def _param_tile_specs(cfg: ModelConfig, mesh):
    with sharding.use_rules(experts=None):
        p_specs = param_specs(registry.decls(cfg), mesh)
    if "embed" in p_specs:
        p_specs["embed"] = sharding.P()
    return p_specs


def mesh_coords(mesh) -> tuple:
    """({axis: size}, {axis: this rank's index}) of a ``DeviceMesh``."""
    sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    return sizes, {a: mesh.get_local_rank(a) for a in sizes}


def _tile_index(part, sizes: Dict[str, int], coords: Dict[str, int]):
    """(index, count) of a rank's tile along one dim whose spec entry is
    ``part``: row-major over the entry's mesh axes."""
    idx, n = 0, 1
    for a in sharding.spec_axes(part):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def _cut(t: torch.Tensor, spec, sizes: Dict[str, int],
         coords: Dict[str, int]) -> torch.Tensor:
    for d, part in enumerate(spec):
        idx, n = _tile_index(part, sizes, coords)
        if n > 1:
            w = t.shape[d] // n
            t = t.narrow(d, idx * w, w)
    return t.clone(memory_format=torch.contiguous_format)


def cut_tiles(tree, specs, sizes: Dict[str, int], coords: Dict[str, int]):
    """This rank's tiles of a tree of full tensors: every leaf cut along
    each dim its spec names, at the rank's mesh ``coords`` ({axis:
    index}), as contiguous copies (the full tensor can be freed)."""
    return tree_map(lambda path, t: _cut(t, tree_at(specs, path), sizes,
                                         coords), tree)


def init_tiles(cfg: ModelConfig, seed: int = 0, *, device="cuda",
               dtype: Optional[torch.dtype] = None):
    """This rank's tiles of ``registry.init(cfg, seed, device=, dtype=)``
    on the serving mesh of ``cfg.mesh_shape`` (the default process group
    must be up): each leaf is drawn whole on ``device``, cut at once and
    the whole one dropped, so a card holds its tiles and at most one
    whole leaf, never the whole model.  Bit-equal to ``cut_tiles`` of
    the whole init; the batcher takes them as they are."""
    mesh, _ = serving_mesh_for(cfg)
    sizes, coords = mesh_coords(mesh)
    specs = _param_tile_specs(cfg, sizes)
    return PP.init_params(
        registry.decls(cfg), seed, device=device, dtype=dtype,
        cut=lambda path, t: _cut(t, tree_at(specs, path), sizes, coords))


def glue_tiles(tiles: List[Any], specs, sizes: Dict[str, int]):
    """The inverse of ``cut_tiles``: the full tensors from the tiles of
    every rank of the mesh (``tiles[r]``, ranks row-major over the axes
    of ``sizes``, in its order)."""
    axes = list(sizes)

    def coords(r):
        c = {}
        for a in reversed(axes):
            r, c[a] = divmod(r, sizes[a])
        return c

    def one(path, _):
        spec = tree_at(specs, path)
        parts = [tree_at(t, path) for t in tiles]
        shape = list(parts[0].shape)
        for d, part in enumerate(spec):
            shape[d] *= _tile_index(part, sizes, coords(0))[1]
        full = parts[0].new_empty(shape)
        for r, t in enumerate(parts):
            region = []
            for d, part in enumerate(spec):
                idx, _ = _tile_index(part, sizes, coords(r))
                region.append(slice(idx * t.shape[d],
                                    (idx + 1) * t.shape[d]))
            full[tuple(region)] = t
        return full
    return tree_map(one, tiles[0])


def local_decls(decls, specs, sizes: Dict[str, int]):
    """``decls`` at the shapes of one rank's tiles."""
    def one(path, d: Decl):
        shape = list(d.shape)
        for i, part in enumerate(tree_at(specs, path)):
            shape[i] //= _tile_index(part, sizes, {a: 0 for a in sizes})[1]
        return dataclasses.replace(d, shape=tuple(shape))
    return tree_map(one, decls)


def _shard_wrap(cfg: ModelConfig, fn):
    """A paged step body as the batcher calls it: under ``manual_axis`` of
    the model group when ``cfg.mesh_shape`` names a serving mesh (the
    body runs the shard-local config on this rank's tiles; block tables,
    slot vectors and token payloads are replicated), else ``fn``
    itself."""
    mesh, axis = serving_mesh_for(cfg)
    if mesh is None:
        return fn
    group = mesh.get_group(axis)

    def body(*args):
        with sharding.manual_axis(group):
            return fn(*args)
    return body


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
    """Batched decode over paged KV: advances all slots at once (under
    ``_shard_wrap``).

    ``step(params, pools, block_tab, last_tok, pos, remaining, active)``
    returns ``(pools, last_tok, pos, remaining, active, out)`` with
    ``out`` the (2, n_slots) int32 [next token, finished] rows.  Inactive
    slots read through a table row of the invalid page id, so their
    writes are masked out and cannot touch pages that were freed and
    handed to another request."""
    layout = get_layout(cfg, page_size)
    fcfg = shard_local_cfg(cfg)

    def step(params, pools, block_tab, last_tok, pos, remaining, active):
        bt = {}
        for g in layout.groups:
            n_pages = tree_leaves(pools[g.name])[0].shape[
                layout.page_axis(g.name)]
            bt[g.name] = torch.where(active[:, None], block_tab[g.name],
                                     n_pages)
        cache = {"pages": pools, "block_tab": bt}
        logits, pools = registry.forward(
            fcfg, params, {"tokens": last_tok[:, None].long()},
            mode="decode", cache=cache, pos=pos)
        return (pools,) + advance_slots(logits, last_tok, pos, remaining,
                                        active, max_seq)

    return _shard_wrap(cfg, step)


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
    fcfg = shard_local_cfg(cfg)

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
            fcfg, params, {"tokens": tokens.long()}, mode="verify",
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

    return _shard_wrap(cfg, fn)


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
    fcfg = shard_local_cfg(cfg)

    def fn(params, pools, block_tab, last_tok, pos, remaining, active,
           tokens, pos0, last_in_chunk, slot_idx, is_final, plen, max_new,
           cache_offset):
        bt_row = {g.name: block_tab[g.name][slot_idx:slot_idx + 1]
                  for g in layout.groups}
        cache = {"pages": pools, "block_tab": bt_row}
        off = torch.full((1,), int(cache_offset), dtype=torch.int32,
                         device=tokens.device)
        logits, pools = registry.forward(
            fcfg, params, {"tokens": tokens.long()}, mode="chunk",
            cache=cache, pos=pos0, last_pos=last_in_chunk, cache_offset=off)
        tok0 = torch.argmax(logits[0, -1], -1).to(torch.int32)
        if is_final:
            last_tok[slot_idx] = tok0
            pos[slot_idx] = plen
            remaining[slot_idx] = max_new - 1
            active[slot_idx] = bool(max_new > 1 and plen < max_seq - 1)
        return pools, last_tok, pos, remaining, active, tok0

    return _shard_wrap(cfg, fn)


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
