"""Port parity: gemma3's local/global layout on the gemma3-12b smoke config.

The smoke config keeps gemma3's structure: 2 groups of 5 sliding-window
layers (window 16, θ 1e4) and 1 global layer (θ 1e6), qk_norm, the
√d_model embedding scale.  The same weights (JAX's
``registry.init(cfg, 0)`` carried across with ``params_from_numpy``,
(G, per)-stacked with ``q_norm``/``k_norm``) and the same numpy-made
tokens go through both packages.  Both compute in float32; caches are
bf16, so a cached element whose fp32 value differs in the last bits
between the frameworks may round to the neighbouring bf16 value: caches
are held to one bf16 ulp of the element, taken at magnitude 1 for
elements below 1 (``_ulps``: fp32 rope and norm values near 0 differ in
more of their few significant bits; measured up to 14 ulps of a 9e-6
element, 2^-7 absolute at most), logits to
``LOGIT_TOL`` absolute (the ``CHUNK_LOGIT_TOL`` idiom of
``tests/test_kv_tiers.py``).  Greedy tokens, ring bases and batcher
counters must be equal.

The port's own contracts hold bit for bit at this width, as the
reference's tests assert them: paged == dense (bf16 and int8, with and
without the kernel twins), speculative == plain, the local group's pages
bounded by the ring's width, and the ring group never shared.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.models.cache_layouts import get_layout, ring_blocks
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
CACHE_ULPS = 1               # bf16 ulps of the element
PAGE = 8


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("gemma3-12b"))
    tcfg = tsmoke(tconfigs.get("gemma3-12b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _ulps(t: torch.Tensor, j) -> float:
    """Largest |t - j| in bf16 ulps of the larger magnitude, at least 1
    (one ulp of a bf16 value x is 2**(floor(log2|x|) - 7))."""
    a = t.float().numpy()
    b = np.asarray(j.astype(jnp.float32))
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(a - b) / ulp).max())


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=48, **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [drain(r) for r in reqs], bat


def _check_allocators(bat):
    assert bat.total_used_pages() == 0
    for alloc in bat._alloc.values():
        alloc.check_consistency()


def _prompts(plens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, L).astype(np.int32) for L in plens]


def _repetitive_prompts(plens):
    """Motif-cycled prompts (the reference's): tiny smoke models decode
    them into short cycles, so the drafter fires."""
    motif = np.asarray([7, 3, 11, 5], np.int32)
    return [np.tile(motif, L // 4 + 1)[:L].astype(np.int32) for L in plens]


# --- the model vs the JAX package ---------------------------------------------------------


def test_train_logits_match_jax(model):
    """A sequence of 40, past the window (16): logits to LOGIT_TOL."""
    jcfg, tcfg, jp, tp = model
    s = 40
    tok = _tokens((2, s), seed=s)
    want = np.asarray(jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)}))
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == want.shape == (2, s, tcfg.padded_vocab)
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_prefill_ring_emission_matches_jax(model, kv):
    """A right-padded 40-token bucket with true lengths 40 and 27 and a
    48-slot cache: the local layers emit the rolled window (slot j holds
    the last true position ≡ j mod 16), the global layers the padded
    cache.  Logits to LOGIT_TOL; bf16 caches to one bf16 ulp; int8 caches
    one step apart at near-ties only, their scales to one bf16 ulp."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    tok = _tokens((2, 40), seed=3)
    last = np.asarray([39, 26], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=48,
                               last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp,
                               {"tokens": torch.from_numpy(tok).long()},
                               mode="prefill", cache_len=48,
                               last_pos=torch.from_numpy(last))
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_TOL
    for kind, S in (("local", 16), ("global", 48)):
        assert set(tc[kind]) == set(jc[kind])
        for leaf in ("k", "v"):
            t, j = tc[kind][leaf], jc[kind][leaf]
            assert tuple(t.shape) == j.shape == (2, 5 if kind == "local"
                                                 else 1, 2, 4, S, 32)
            if kv == "int8":
                diff = np.abs(t.numpy().astype(int) - np.asarray(j))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
                assert _ulps(tc[kind][leaf + "_scale"],
                             jc[kind][leaf + "_scale"]) <= CACHE_ULPS
            else:
                assert _ulps(t, j) <= CACHE_ULPS, (kind, leaf)


@pytest.mark.parametrize("decode_flash", [False, True])
def test_greedy_tokens_past_the_window_match_jax(model, decode_flash):
    """Greedy decode from dense slot caches, two prompts of 12 tokens and
    10 steps: the local layers' ring (16 slots) wraps during decode;
    tokens equal JAX's (the port's B3 twin on the ring with
    ``decode_flash``) and the full sequences' train-mode argmax, as
    ``tests/test_models.py``'s ring test holds it."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, decode_flash=decode_flash)
    tcfg = dataclasses.replace(tcfg, decode_flash=decode_flash)
    plen = 12
    tok = _tokens((2, plen), seed=plen)
    gold = np.asarray(jgreedy(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              steps=10, max_seq=32))
    got = tgreedy(tcfg, tp, {"tokens": tok}, steps=10, max_seq=32,
                  device="cpu")
    np.testing.assert_array_equal(got, gold)
    full = torch.from_numpy(np.concatenate([tok, got], 1)).long()
    logits = tregistry.forward(tcfg, tp, {"tokens": full})
    np.testing.assert_array_equal(
        logits[:, plen - 1:-1].argmax(-1).numpy(), got)


def test_ring_page_base_matches_jax():
    rng = np.random.default_rng(0)
    for page, nb in ((8, 3), (16, 65), (16, 66), (4, 5)):
        pos = np.concatenate([np.arange(2 * page * nb),
                              rng.integers(0, 4096, 64)]).astype(np.int32)
        want = np.asarray(jlayers._ring_page_base(jnp.asarray(pos), page, nb))
        got = tlayers.ring_page_base(torch.from_numpy(pos), page, nb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_layout_and_pool_decls(model):
    """Groups, widths, saturation and pool shapes as the reference's."""
    _, tcfg, _, _ = model
    w = tcfg.sliding_window
    lay = get_layout(dataclasses.replace(tcfg, kv_page_size=PAGE), PAGE)
    assert [g.name for g in lay.groups] == ["local", "global"]
    assert lay.group("local").ring and not lay.group("global").ring
    assert lay.n_blocks("local", 64) == ring_blocks(w, PAGE) == 3
    assert lay.n_blocks("global", 64) == 8
    assert lay.blocks_for("local", 40, 64) == 3
    assert lay.blocks_for("global", 40, 64) == 5
    spec = dataclasses.replace(tcfg, speculate_k=4)
    assert get_layout(spec, PAGE).n_blocks("local", 64) == ring_blocks(
        w + 4, PAGE) == 4
    assert get_layout(tsmoke(tconfigs.get("gemma3-12b")), 16).n_blocks(
        "local", 8) == 1                    # never wider than the flat table
    decls = tregistry.paged_cache_decls(tcfg, {"local": 6, "global": 9}, 8)
    assert decls["local"]["k"].shape == (2, 5, 6, 4, 8, 32)
    assert decls["global"]["v"].shape == (2, 1, 9, 4, 8, 32)
    assert lay.page_axis("local") == lay.page_axis("global") == 2
    assert tregistry.paged_supported(tcfg)


# --- the batcher: paged == dense, the ring bound, spec == plain ----------------------------


@pytest.mark.parametrize("extra", [{}, {"kv_cache_dtype": "int8"},
                                   {"decode_flash": True}])
def test_paged_matches_dense(model, extra):
    """``tests/test_paged_kv.py``'s gemma3 case (prompts of 5, 12 and 21
    tokens, one prefill chunk each), plus int8 pools and the kernel
    twins: the paged batcher gives the dense batcher's tokens, and every
    page comes back."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, **extra)
    prompts = _prompts([5, 12, 21])
    max_news = [4, 3, 4]
    gold, _ = _run(cfg, tp, prompts, max_news)
    pcfg = dataclasses.replace(cfg, kv_page_size=PAGE)
    got, bat = _run(pcfg, tp, prompts, max_news, prefill_chunk=32)
    assert bat.paged
    assert got == gold
    _check_allocators(bat)


@pytest.mark.parametrize("decode_flash", [False, True])
def test_preempt_resume_over_two_groups(model, decode_flash):
    """Small pools in both groups force preemption mid-decode past the
    window: spilled ring and flat pages resume bit-identically."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, decode_flash=decode_flash)
    prompts = _prompts([10, 21, 14], seed=4)
    max_news = [20, 14, 18]
    gold, _ = _run(cfg, tp, prompts, max_news)
    got, bat = _run(dataclasses.replace(cfg, kv_page_size=PAGE), tp,
                    prompts, max_news, prefill_chunk=PAGE,
                    n_pages={"local": 5, "global": 7})
    assert got == gold
    assert bat.preemptions > 0 and bat.resumes == bat.preemptions
    _check_allocators(bat)


def test_local_pages_window_bounded(model):
    """``tests/test_paged_kv.py``'s window test: the ring's table width
    (so every slot's local page count) is O(window/page) whatever
    max_seq; a 40-token prompt prefilled in one chunk (the ring wraps
    inside it) and decoded gives the greedy tokens while holding at most
    ring-width local pages."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, kv_page_size=PAGE)
    w = cfg.sliding_window
    bat = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=64, device="cpu")
    assert bat.n_blocks["local"] == w // PAGE + 1     # ring, not 64/8
    assert bat.n_blocks["global"] == 64 // PAGE
    prompt = _prompts([40], seed=40)[0]
    gold = list(tgreedy(tcfg, tp, {"tokens": prompt[None]}, steps=6,
                        max_seq=64, device="cpu")[0])
    got, bat = _run(cfg, tp, [prompt], [6], max_seq=64, prefill_chunk=64)
    assert got == [gold]
    assert bat.peak_pages <= (w // PAGE + 1) + -(-64 // PAGE)
    _check_allocators(bat)


def test_ring_group_not_shareable(model):
    """``tests/test_prefix_cache.py``'s gemma3 case: the ring group is not
    shareable, so ``prefix_cache=True`` serves with the cache off, the
    same prompt twice gives the greedy tokens twice, and no hit is
    counted."""
    _, tcfg, _, tp = model
    layout = get_layout(dataclasses.replace(tcfg, kv_page_size=PAGE), PAGE)
    assert not layout.group("local").shareable
    assert layout.group("global").shareable
    assert not layout.prefix_shareable
    pcfg = dataclasses.replace(tcfg, kv_page_size=PAGE, prefix_cache=True)
    bat = ContinuousBatcher(pcfg, tp, n_slots=2, max_seq=64, device="cpu")
    assert bat.paged and not bat.prefix_cache
    P = _prompts([12], seed=12)[0]
    outs = []
    for rid in range(2):
        r = Request(rid=rid, prompt=P.copy(), max_new=4)
        bat.submit(r)
        bat.run(rid + 1)
        outs.append(drain(r))
    gold = list(tgreedy(tcfg, tp, {"tokens": P[None]}, steps=4, max_seq=64,
                        device="cpu")[0])
    assert outs == [gold, gold]
    st = bat.stats()
    assert not st["prefix_cache"]
    assert bat.prefix_hits == bat.prefix_lookups == 0
    _check_allocators(bat)


def _spec_cfg(cfg, k=4, **kw):
    base = dict(kv_page_size=PAGE, prefill_chunk=PAGE, speculate_k=k,
                speculate_ngram=1)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


@pytest.mark.parametrize("extra", [{}, {"kv_cache_dtype": "int8"},
                                   {"decode_flash": True}])
def test_spec_equals_plain(model, extra):
    """``tests/test_spec_decode.py``'s gemma3 case: motif prompts, 16 new
    tokens, decode past the window so verify spans write across the
    ring's wrap (its width padded by speculate_k); plus int8 pools and
    the kernel twins.  Speculation drafts and gives plain decode's
    tokens; every scratch page comes back."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, **extra)
    prompts = _repetitive_prompts([9, 14, 6, 12])
    max_news = [16, 16, 16, 16]
    plain, _ = _run(_spec_cfg(cfg, k=0), tp, prompts, max_news)
    spec, bat = _run(_spec_cfg(cfg), tp, prompts, max_news)
    assert spec == plain
    st = bat.stats()["speculation"]
    assert st["drafted"] > 0 and st["accepted"] > 0
    assert st["drafted"] == st["accepted"] + st["rolled_back"]
    assert bat.n_blocks["local"] == ring_blocks(cfg.sliding_window + 4, PAGE)
    _check_allocators(bat)


def test_batcher_matches_jax_batcher(model):
    """The paged batcher with speculation streams the JAX batcher's
    tokens, with its steps, prefill chunks, preemptions, peak pages and
    speculation counters (small pools, so both preempt); without
    speculation it streams the same tokens."""
    jcfg, tcfg, jp, tp = model
    prompts = _repetitive_prompts([9, 14, 6, 12, 21])
    kw = dict(n_slots=2, max_seq=48, n_pages={"local": 6, "global": 9})
    jbat = jbatching.ContinuousBatcher(_spec_cfg(jcfg), jp, **kw)
    jreqs = [jbatching.Request(rid=i, prompt=p, max_new=16)
             for i, p in enumerate(prompts)]
    prod = threading.Thread(target=lambda: [jbat.submit(r) for r in jreqs])
    prod.start()
    jbat.run(len(jreqs))
    prod.join()
    gold = [jbatching.drain(r) for r in jreqs]
    got, bat = _run(_spec_cfg(tcfg), tp, prompts, [16] * len(prompts), **kw)
    assert got == gold
    st, jst = bat.stats(), jbat.stats()
    keys = ("steps", "prefill_chunks", "preemptions")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert bat.peak_pages == jbat.peak_pages
    keys = ("drafted", "accepted", "rolled_back", "verify_steps")
    assert {k: st["speculation"][k] for k in keys} \
        == {k: jst["speculation"][k] for k in keys}
    assert st["speculation"]["drafted"] > 0
    _check_allocators(bat)
    plain, _ = _run(_spec_cfg(tcfg, k=0), tp, prompts, [16] * len(prompts),
                    **kw)
    assert plain == gold
