"""Port parity: the refcounted prefix cache on the paged batcher.

The reference's ``tests/test_prefix_cache.py`` cases that the port's
flat page layout runs (its gemma3 ring and MLA latent cases wait for
those layouts), on the same weights (JAX's ``registry.init(cfg, 0)``
carried across with ``params_from_numpy``) with the port's dense
``greedy_generate`` as the oracle: refcounted allocation, the radix-tree
``PrefixIndex``, hit == cold with one catch-up chunk, copy-on-write at
both trigger points, preemption of a slot holding shared pages,
retire-then-rehit, eviction before preemption, the pinned match, and
``prefill_exact``.  Across frameworks: the port's batcher streams the
JAX batcher's tokens with the same prefix counters, a seeded random
sequence of insert/match/evict gives the same results from both
``PrefixIndex``es, and ``copy_pages`` moves int8 value pages with their
scale pages.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro.serve.prefix_cache import PrefixIndex as JPrefixIndex
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.models.cache_layouts import get_layout
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.prefix_cache import PageAllocator, PrefixIndex
from repro_torch.serve.serve_loop import greedy_generate

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _greedy(cfg, params, prompt, steps, max_seq=64):
    return list(greedy_generate(cfg, params, {"tokens": prompt[None]},
                                steps=steps, max_seq=max_seq,
                                device="cpu")[0])


def _batcher(cfg, params, **kw):
    return ContinuousBatcher(cfg, params, device="cpu", **kw)


def _serve_seq(bat, prompts, max_news):
    """Serve requests one after another through a LIVE batcher (so the
    prefix index accumulates across requests)."""
    outs = []
    for i, (p, mn) in enumerate(zip(prompts, max_news)):
        r = Request(rid=i, prompt=p, max_new=mn)
        t = threading.Thread(target=lambda r=r: bat.submit(r))
        t.start()
        bat.run(bat.retired + 1)
        t.join()
        outs.append(drain(r))
    return outs


def _pcfg(cfg, page=8, **kw):
    return dataclasses.replace(cfg, kv_page_size=page, prefix_cache=True,
                               **kw)


# --- refcounted allocator -------------------------------------------------------------


def test_allocator_refcount_share_and_release():
    a = PageAllocator(6)
    p = a.alloc(3)
    assert a.used_pages == 3 and a.shared_pages == 0
    a.incref(p)
    assert a.shared_pages == 3
    a.free(p)
    assert a.used_pages == 3 and a.free_pages == 3
    assert a.shared_pages == 0
    a.free(p)
    assert a.used_pages == 0 and a.free_pages == 6
    p1 = a.alloc(2)
    a.incref(p1)
    p2 = a.alloc(4)
    assert set(p1) & set(p2) == set()


def test_allocator_double_free_and_foreign_free_hardened():
    a = PageAllocator(4)
    p = a.alloc(2)
    a.free(p)
    with pytest.raises(ValueError, match="already freed|unallocated"):
        a.free(p)
    with pytest.raises(ValueError, match="unallocated"):
        a.free([3] if 3 not in p else [p[0] ^ 1 ^ p[0]])
    with pytest.raises(ValueError, match="out-of-range"):
        a.free([99])
    with pytest.raises(ValueError, match="out-of-range"):
        a.free([-1])
    with pytest.raises(ValueError, match="unallocated"):
        a.incref([0])
    assert sorted(a.alloc(4)) == [0, 1, 2, 3]


# --- radix-tree prefix index ----------------------------------------------------------


def test_prefix_index_full_and_partial_match():
    idx = PrefixIndex(["kv"], page=4, block=4)
    idx.insert(np.arange(12, dtype=np.int32), {"kv": [10, 11, 12]})
    assert idx.n_nodes == 3
    m, pages = idx.match(np.arange(8, dtype=np.int32))
    assert m == 8 and pages["kv"] == [10, 11]
    probe = np.asarray([0, 1, 2, 3, 4, 5, 99, 98], np.int32)
    m, pages = idx.match(probe)
    assert m == 6 and pages["kv"] == [10, 11]
    idx.insert(probe, {"kv": [20, 21]})
    assert idx.n_nodes == 4
    m, pages = idx.match(probe)
    assert m == 8 and pages["kv"] == [10, 21]
    m, pages = idx.match(np.asarray([7, 7, 7, 7], np.int32))
    assert m == 0 and pages["kv"] == []


def test_prefix_index_insert_dedup_and_lru_eviction():
    idx = PrefixIndex(["kv"], page=4, block=4)
    assert idx.insert(np.arange(8, dtype=np.int32), {"kv": [0, 1]}) == [0, 1]
    assert idx.insert(np.arange(8, dtype=np.int32), {"kv": [5, 6]}) == []
    branch = np.asarray([0, 1, 2, 3, 9, 9, 9, 9], np.int32)
    idx.insert(branch, {"kv": [7, 8]})
    idx.match(branch)
    assert idx.evict_lru() == ((0, 1, 2, 3, 4, 5, 6, 7), {"kv": [1]})
    assert idx.evict_lru() == ((0, 1, 2, 3, 9, 9, 9, 9), {"kv": [8]})
    assert idx.evict_lru() == ((0, 1, 2, 3), {"kv": [0]})
    assert idx.evict_lru() is None and idx.n_nodes == 0


def test_prefix_index_rejects_unaligned_block():
    with pytest.raises(ValueError, match="multiple of the page"):
        PrefixIndex(["kv"], page=8, block=12)


def test_prefix_index_random_ops_match_jax():
    """A seeded random sequence of insert, match, matched_blocks and
    evict_lru over a small alphabet (so prefixes collide) gives the same
    results from the port's index and the JAX package's."""
    rng = np.random.default_rng(7)
    t, j = PrefixIndex(["kv"], page=4, block=8), \
        JPrefixIndex(["kv"], page=4, block=8)
    next_page = 0
    for step in range(400):
        op = rng.integers(0, 4)
        prompt = rng.integers(0, 3, int(rng.integers(1, 40))).astype(np.int32)
        if op == 0:
            n = -(-len(prompt) // 4)
            pages = {"kv": list(range(next_page, next_page + n))}
            next_page += n
            assert t.insert(prompt, pages) == j.insert(prompt, pages), step
        elif op == 1:
            assert t.match(prompt) == j.match(prompt), step
        elif op == 2:
            assert t.matched_blocks(prompt) == j.matched_blocks(prompt), step
        else:
            assert t.evict_lru() == j.evict_lru(), step
        assert t.n_nodes == j.n_nodes and t.n_pages == j.n_pages
    assert sorted(t.walk()) == sorted(j.walk())


# --- cache-hit admission: token identity + skipped prefill ----------------------------


def test_hit_skips_prefill_and_matches_cold(model):
    cfg, tp, _, _ = model
    P = _prompt(cfg, 32, seed=10)
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64, prefill_chunk=8)
    cold, hit = _serve_seq(bat, [P, P], [6, 6])
    assert cold == _greedy(cfg, tp, P, 6)
    assert hit == cold
    assert bat.prefix_hits == 1 and bat.prefix_hit_tokens == 32
    assert bat.prefill_chunks == 4 + 1
    st = bat.stats()
    assert st["prefix_hit_rate"] == 0.5 and st["cached_prefixes"] == 4


@pytest.mark.parametrize("kw", [{"sliding_window": 16},
                                {"kv_cache_dtype": "int8"}])
def test_hit_token_identical_across_shareable_layouts(model, kw):
    """The windowed flat pages and int8 + scale pages serve a hit with
    the cold run's tokens (the reference's MLA case waits for the MLA
    layout)."""
    base, tp, _, _ = model
    cfg = dataclasses.replace(base, **kw)
    assert get_layout(cfg, 8).prefix_shareable
    P = _prompt(cfg, 24, seed=11)
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64)
    cold, hit = _serve_seq(bat, [P, P], [5, 5])
    assert hit == cold == _greedy(cfg, tp, P, 5)
    assert bat.prefix_hits == 1


# --- copy-on-write --------------------------------------------------------------------


def test_divergence_mid_page_cow(model):
    cfg, tp, _, _ = model
    P = _prompt(cfg, 24, seed=13)
    P2 = P.copy()
    P2[20:] = (P2[20:] + 7) % cfg.vocab_size
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64)
    out1, out2, out1b = _serve_seq(bat, [P, P2, P], [5, 5, 5])
    assert out1 == _greedy(cfg, tp, P, 5)
    assert out2 == _greedy(cfg, tp, P2, 5)
    assert out1b == out1
    assert bat.cow_copies >= 1 and bat.prefix_hits >= 2
    m, _ = bat._prefix.match(np.asarray(P2, np.int32))
    assert m == 24


def test_decode_cow_first_write_past_shared_page(model):
    cfg, tp, _, _ = model
    P = _prompt(cfg, 24, seed=14)
    P3 = P[:20].copy()
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64)
    out1, out3, out1b = _serve_seq(bat, [P, P3, P], [5, 5, 5])
    assert out1 == _greedy(cfg, tp, P, 5)
    assert out3 == _greedy(cfg, tp, P3, 5)
    assert out1b == out1
    assert bat.cow_copies >= 1 and bat.prefix_hits >= 2


def test_copy_pages_moves_int8_values_and_scales(model):
    cfg, _, _, _ = model
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    layout = get_layout(cfg, 8)
    pools = tparams.init_params(tregistry.paged_cache_decls(cfg, 6, 8),
                                device="cpu")
    for leaf in pools["kv"].values():
        leaf.copy_(torch.randn(leaf.shape).mul(50).to(leaf.dtype))
    before = {n: a.clone() for n, a in pools["kv"].items()}
    layout.copy_pages(pools, "kv", [1, 4], [5, 0])
    assert set(pools["kv"]) == {"k", "v", "k_scale", "v_scale"}
    for n, a in pools["kv"].items():
        assert torch.equal(a[:, 5], before[n][:, 1])
        assert torch.equal(a[:, 0], before[n][:, 4])
        assert torch.equal(a[:, 1:5], before[n][:, 1:5]), n


# --- preemption / retire / eviction interleavings -------------------------------------


def test_preempt_victim_holding_shared_pages_resumes_identically(model):
    cfg, tp, _, _ = model
    sysp = _prompt(cfg, 16, seed=15)
    p1 = np.concatenate([sysp, _prompt(cfg, 4, seed=16)])
    p2 = np.concatenate([sysp, _prompt(cfg, 4, seed=17)])
    golds = [_greedy(cfg, tp, p, 8) for p in (p1, p2)]
    bat = _batcher(_pcfg(cfg, page=4), tp, n_slots=2, max_seq=64, n_pages=9)
    seed = Request(rid=9, prompt=sysp, max_new=2)
    t = threading.Thread(target=lambda: bat.submit(seed))
    t.start()
    bat.run(1)
    t.join()
    drain(seed)
    r1 = Request(rid=0, prompt=p1, max_new=8)
    r2 = Request(rid=1, prompt=p2, max_new=8)
    t = threading.Thread(target=lambda: (bat.submit(r1), bat.submit(r2)))
    t.start()
    bat.run(3)
    t.join()
    assert [drain(r1), drain(r2)] == golds
    assert bat.prefix_hits == 2
    assert bat.preemptions > 0 and bat.resumes > 0
    for alloc in bat._alloc.values():
        assert alloc.used_pages == bat._prefix.n_pages
        assert alloc.shared_pages == 0
        alloc.check_consistency()


def test_retire_then_rehit_serves_without_recompute(model):
    cfg, tp, _, _ = model
    A = _prompt(cfg, 24, seed=18)
    B = _prompt(cfg, 16, seed=19)
    bat = _batcher(_pcfg(cfg), tp, n_slots=1, max_seq=64, prefill_chunk=8)
    outs = _serve_seq(bat, [A, B, A], [4, 4, 4])
    assert outs[0] == _greedy(cfg, tp, A, 4)
    assert outs[1] == _greedy(cfg, tp, B, 4)
    assert outs[2] == outs[0]
    assert bat.prefix_hits == 1
    assert bat.prefill_chunks == 3 + 2 + 1


def test_eviction_under_pressure_frees_cache_before_preempting(model):
    cfg, tp, _, _ = model
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64, n_pages=8)
    prompts = [_prompt(cfg, 16, seed=20 + i) for i in range(4)]
    outs = _serve_seq(bat, prompts, [6] * 4)
    for p, o in zip(prompts, outs):
        assert o == _greedy(cfg, tp, p, 6)
    assert bat.prefix_evictions > 0
    assert bat.preemptions == 0


def test_admission_eviction_cannot_free_matched_prefix(model):
    cfg, tp, _, _ = model
    A = _prompt(cfg, 16, seed=30)
    X = _prompt(cfg, 30, seed=31)
    B = np.concatenate([A, _prompt(cfg, 24, seed=32)])
    gold_x = _greedy(cfg, tp, X, 2)
    gold_b = _greedy(cfg, tp, B, 4)
    bat = _batcher(_pcfg(cfg), tp, n_slots=2, max_seq=64, n_pages=8)
    _serve_seq(bat, [A], [2])
    assert bat._prefix.n_nodes == 2
    rx = Request(rid=1, prompt=X, max_new=2)
    t = threading.Thread(target=lambda: bat.submit(rx))
    t.start()
    while not bat._admitting:
        bat.admit()
    while bat._admitting:
        bat._prefill_step()
    t.join()
    rb = Request(rid=2, prompt=B, max_new=4)
    t = threading.Thread(target=lambda: bat.submit(rb))
    t.start()
    bat.admit()
    t.join()
    assert bat.prefix_evictions >= 2 and bat._prefix.n_nodes == 0
    bat.run(3)
    assert drain(rx) == gold_x
    assert drain(rb) == gold_b
    for alloc in bat._alloc.values():
        assert alloc.used_pages == bat._prefix.n_pages


def test_unshared_behavior_unchanged_when_disabled(model):
    cfg, tp, _, _ = model
    bat = _batcher(dataclasses.replace(cfg, kv_page_size=8), tp, n_slots=2,
                   max_seq=64)
    P = _prompt(cfg, 24, seed=25)
    outs = _serve_seq(bat, [P, P], [4, 4])
    assert outs[0] == outs[1] == _greedy(cfg, tp, P, 4)
    assert not bat.prefix_cache and bat.prefix_hits == 0
    assert bat.total_used_pages() == 0


def test_dense_slots_switch_the_prefix_cache_off(model):
    """As in the reference, the dense-slot batcher serves a prefix-cache
    config without raising, the cache off."""
    cfg, tp, _, _ = model
    bat = _batcher(dataclasses.replace(cfg, prefix_cache=True), tp,
                   n_slots=2, max_seq=64, prefix_cache=True)
    P = _prompt(cfg, 12, seed=26)
    outs = _serve_seq(bat, [P, P], [4, 4])
    assert not bat.paged and not bat.prefix_cache
    assert outs[0] == outs[1] == _greedy(cfg, tp, P, 4)


# --- chunked-prefill exactness mode ---------------------------------------------------


def _admit_only(cfg, params, P, chunk, exact, max_seq=64):
    pcfg = dataclasses.replace(cfg, kv_page_size=8, prefill_exact=exact)
    bat = _batcher(pcfg, params, n_slots=1, max_seq=max_seq,
                   prefill_chunk=chunk)
    r = Request(rid=0, prompt=P, max_new=4)
    bat.submit(r)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    pages = bat._slot_pages["kv"][0][:-(-len(P) // 8)]
    snap = {k: bat.pools["kv"][k][:, pages].clone() for k in ("k", "v")}
    bat.run(1)
    return snap, drain(r)


def test_prefill_exact_pool_bits_independent_of_chunking(model):
    cfg, tp, _, _ = model
    P = _prompt(cfg, 40, seed=26)
    ref_snap, ref_toks = _admit_only(cfg, tp, P, 64, exact=False)
    ex_snap, ex_toks = _admit_only(cfg, tp, P, 16, exact=True)
    for k in ("k", "v"):
        assert torch.equal(ref_snap[k], ex_snap[k]), k
    assert ref_toks == ex_toks == _greedy(cfg, tp, P, 4)


def test_prefill_exact_hit_token_identical_to_cold(model):
    cfg, tp, _, _ = model
    P = _prompt(cfg, 40, seed=27)
    pcfg = _pcfg(cfg, prefill_exact=True)
    bat = _batcher(pcfg, tp, n_slots=2, max_seq=64, prefill_chunk=16)
    cold, hit = _serve_seq(bat, [P, P], [6, 6])
    bat2 = _batcher(pcfg, tp, n_slots=2, max_seq=64, prefill_chunk=8)
    cold_b, hit_b = _serve_seq(bat2, [P, P], [6, 6])
    assert hit == cold == cold_b == hit_b
    assert bat.prefix_hits == 1 and bat2.prefix_hits == 1


# --- across frameworks ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8",
                                     "decode_flash": True}])
def test_prefix_batcher_matches_jax_batcher(model, kw):
    """A shared system prompt, a mid-page divergence and a strict
    prefix, served through a live batcher: the port streams the JAX
    batcher's tokens with its prefix counters, steps and chunks."""
    cfg, tp, jcfg, jp = model
    sysp = _prompt(cfg, 20, seed=40)
    prompts = [np.concatenate([sysp, _prompt(cfg, n, seed=41 + n)])
               for n in (4, 9, 0)] + [sysp[:13]]
    extra = dict(kv_page_size=8, prefix_cache=True, prefill_exact=True,
                 **kw)
    jbat = jbatching.ContinuousBatcher(dataclasses.replace(jcfg, **extra),
                                       jp, n_slots=2, max_seq=64)
    jouts = []
    for i, p in enumerate(prompts):
        r = jbatching.Request(rid=i, prompt=p, max_new=5)
        jbat.submit(r)
        jbat.run(jbat.retired + 1)
        jouts.append(jbatching.drain(r))
    bat = _batcher(dataclasses.replace(cfg, **extra), tp, n_slots=2,
                   max_seq=64)
    outs = _serve_seq(bat, prompts, [5] * len(prompts))
    assert outs == jouts
    keys = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "prefix_evictions", "cow_copies", "shared_pages",
            "cached_prefixes", "cached_prefix_pages", "steps",
            "prefill_chunks")
    st, jst = bat.stats(), jbat.stats()
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["prefix_hits"] >= 3 and st["cow_copies"] >= 1
    for alloc in bat._alloc.values():
        alloc.check_consistency()
