"""C5: a prefill attends in blocks and never holds the whole score
matrix.

A ``roofline.count.Counter`` with ``by_formula=False`` records the size
of every tensor the prefill allocates while it really runs.  The largest
must stay O(sq · block_k) per head — here under b · hq · sq · block_k
fp32 elements — where one masked softmax over the whole (sq, sk) matrix
(``layers.attention_xla``, the plain oracle) allocates b · hq · sq · sk:
minitron at s 1024 with 128-wide tiles, gemma3's local layers with their
window (which also visit only the live band of tiles), deepseek's MLA
prefill.  With ``attn_p_bf16`` the prefill still matches the reference's
prefill logits at the cross-framework tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import layers as L
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.roofline import count as C

torch.set_num_threads(2)

S, TILE = 1024, 128
LOGIT_TOL = 1e-3             # the cross-framework logit tolerance
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2


def _cfg(arch, **kw):
    return dataclasses.replace(tsmoke(tconfigs.get(arch)), attn_block_q=TILE,
                               attn_block_k=TILE, **kw)


def _prefill(cfg, s=S, b=1):
    """Run a prefill of s random tokens under an allocation recorder;
    returns its costs (largest allocation, ops)."""
    params = tregistry.init(cfg, 0, device="cpu")
    batch = tregistry.make_batch(cfg, "prefill", b, s, device="cpu")
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad(), C.Counter(scopes=False, by_formula=False) as c:
        logits, cache = tregistry.forward(cfg, params, batch, mode="prefill",
                                          cache_len=s)
    assert torch.isfinite(logits).all()
    return c.costs


def _whole_matrix_bytes(b, hq, s):
    return b * hq * s * s * 4


def _tile_bound(b, hq, s):
    return b * hq * s * TILE * 4


def test_whole_matrix_oracle_exceeds_the_bound():
    """The plain oracle allocates the whole (sq, sk) matrix, so the bound
    below tells the two paths apart."""
    b, hq, hkv, d = 1, 4, 2, 32
    q, k, v = (torch.randn(b, h, S, d) for h in (hq, hkv, hkv))
    with C.Counter(scopes=False, by_formula=False) as c:
        L.attention_xla(q, k, v)
    assert c.costs.largest_alloc >= _whole_matrix_bytes(b, hq, S)
    with C.Counter(scopes=False, by_formula=False) as c:
        L.attention_prefill(q, k, v, block_q=TILE, block_k=TILE)
    assert c.costs.largest_alloc <= _tile_bound(b, hq, S)


def test_minitron_prefill_allocates_tiles():
    cfg = _cfg("minitron-4b")
    costs = _prefill(cfg)
    assert costs.largest_alloc <= _tile_bound(1, cfg.n_heads, S), \
        costs.largest_alloc


def test_gemma3_local_layers_visit_the_band():
    """gemma3 with a 128 window and ``attn_block_skip``: every local layer
    visits only the live band of tiles, every global layer the causal
    tiles — two products per tile, so against a run without skipping
    (every tile) the skipping run does (64 - band) tiles' products fewer
    per local layer and (64 - 36) per global one — and no tensor reaches
    the whole matrix."""
    G, per = tsmoke(tconfigs.get("gemma3-12b")).group_layout
    runs = {skip: _prefill(_cfg("gemma3-12b", sliding_window=TILE,
                                attn_block_skip=skip))
            for skip in (False, True)}
    n_local = G * tconfigs.get("gemma3-12b").local_global_pattern
    n_global = G * per - n_local
    band, _, _ = C.blocked_tiles(S, S, True, TILE, TILE, TILE, True)
    causal, _, _ = C.blocked_tiles(S, S, True, None, TILE, TILE, True)
    every = (S // TILE) ** 2
    assert band == 2 * (S // TILE) - 1 and causal == 36 and every == 64
    cfg = _cfg("gemma3-12b")
    tile = 2 * 2 * cfg.n_heads * TILE * TILE * cfg.head_dim   # QK and PV
    fewer = runs[False].flops - runs[True].flops
    assert fewer == tile * (n_local * (every - band)
                            + n_global * (every - causal))
    assert runs[True].largest_alloc <= _tile_bound(1, 4, S)


def test_rows_with_no_live_key_give_zero():
    """C3: a query with no live key gives 0 (no NaN) — more queries than
    keys (the first rows sit before every key) and a zero window."""
    q, k, v = torch.randn(1, 4, 40, 16), torch.randn(1, 2, 24, 16), \
        torch.randn(1, 2, 24, 16)
    out = L.attention_prefill(q, k, v, block_q=16, block_k=8,
                              block_skip=True)
    assert torch.isfinite(out).all()
    assert not out[:, :, :16].any() and out[:, :, 16:].abs().sum() > 0
    out = L.attention_prefill(q[:, :, :24], k, v, window=0, block_q=8,
                              block_k=8, block_skip=True)
    assert torch.isfinite(out).all() and not out.any()


def test_deepseek_mla_prefill_allocates_tiles():
    cfg = _cfg("deepseek-v2-lite-16b")
    costs = _prefill(cfg)
    assert costs.largest_alloc <= _tile_bound(1, cfg.n_heads, S), \
        costs.largest_alloc


def test_p_bf16_prefill_matches_the_reference(arch="minitron-4b"):
    """``attn_p_bf16`` rounds the probabilities and values to bf16 for the
    PV product in the port's prefill as in the reference's: logits at
    the cross-framework tolerance, caches to one bf16 ulp, on tiles
    small enough that the prompt spans several."""
    kw = dict(attn_p_bf16=True, attn_block_q=8, attn_block_k=8,
              attn_block_skip=True)
    jcfg = dataclasses.replace(jsmoke(jconfigs.get(arch)), **kw)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get(arch)), **kw)
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    tok = np.random.default_rng(3).integers(0, 512, (2, 29)).astype(np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=32)
    tl, tc = tregistry.forward(tcfg, tp,
                               {"tokens": torch.from_numpy(tok).long()},
                               mode="prefill", cache_len=32)
    diff = float(np.abs(tl.float().numpy()
                        - np.asarray(jl.astype(jnp.float32))).max())
    assert diff <= LOGIT_TOL, diff

    def hold(path, tleaf):
        jleaf = jc
        for key in path:
            jleaf = jleaf[key]
        assert tuple(tleaf.shape) == jleaf.shape, path
        assert float(np.abs(tleaf.float().numpy() - np.asarray(
            jleaf.astype(jnp.float32))).max()) <= CACHE_TOL, path

    tparams.tree_map(hold, tc)
