"""Port parity: tiered KV memory (``serve/kv_tiers.py``) on the paged
batcher.

The reference's ``tests/test_kv_tiers.py`` cases for the flat layouts
(bf16, windowed, int8 with scale pages; MLA latent pages wait for that
layout) on the same weights (JAX's ``registry.init(cfg, 0)`` carried
across with ``params_from_numpy``), the port's dense ``greedy_generate``
as the oracle where the reference uses its own: the T1 store's budget and
LRU against the reference ``HostPageStore`` on one seeded sequence of
operations, ``_content_key`` byte-equal to the reference's, the staged
engine's dtype round trip and the float-into-int8 refusal, snapshot
geometry checks (and a JAX-written snapshot refused), demote -> rehit
with bit-identical restored pages, T1 eviction never stranding a
refcounted page, a snapshot restart paying only the catch-up chunk, int8
preemption spill, the recompute policy, the tier switched off, and
gemma3's preemption over both groups through the engine.  Across
frameworks: the port streams the JAX batcher's tokens with its tier and
transfer counters (exact).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.models.cache_layouts import get_layout as jget_layout
from repro.serve import batching as jbatching
from repro.serve import kv_tiers as jtiers
from repro.serve.prefix_cache import PrefixIndex as JPrefixIndex
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.models.cache_layouts import get_layout
from repro_torch.serve import kv_tiers as ttiers
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.kv_tiers import (HostPageStore, KVTierManager,
                                        SnapshotCorruptError,
                                        StagedTransferEngine)
from repro_torch.serve.prefix_cache import PrefixIndex
from repro_torch.serve.serve_loop import greedy_generate

torch.set_num_threads(2)


def _bridge(jp):
    return tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    return tsmoke(tconfigs.get("minitron-4b")), _bridge(jp), jcfg, jp


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _greedy(cfg, params, prompt, steps, max_seq=64):
    return list(greedy_generate(cfg, params, {"tokens": prompt[None]},
                                steps=steps, max_seq=max_seq,
                                device="cpu")[0])


def _batcher(cfg, params, **kw):
    return ContinuousBatcher(cfg, params, device="cpu", **kw)


def _serve_seq(bat, prompts, max_news, req=Request, drain_fn=drain):
    """Serve requests one after another through a LIVE batcher (the
    prefix index and the host tier accumulate across requests)."""
    outs = []
    for i, (p, mn) in enumerate(zip(prompts, max_news)):
        r = req(rid=100 + i, prompt=p, max_new=mn)
        t = threading.Thread(target=lambda r=r: bat.submit(r))
        t.start()
        bat.run(bat.retired + 1)
        t.join(timeout=30)
        outs.append(drain_fn(r, timeout=30))
    return outs


def _tier_cfg(cfg, page=8, chunk=8, budget=1 << 20, restore_min=0,
              snapshot="", **kw):
    return dataclasses.replace(
        cfg, kv_page_size=page, prefill_chunk=chunk, prefix_cache=True,
        kv_host_tier_bytes=budget, tier_restore_min_tokens=restore_min,
        kv_tier_snapshot=snapshot, **kw)


def _run_all(bat, prompts, max_new):
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    t = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    t.start()
    bat.run(len(reqs))
    t.join(timeout=30)
    return [drain(r, timeout=30) for r in reqs]


def _uncontended(pcfg, params, prompts, max_new, max_seq=64):
    """Oracle of the preemption tests: the same config with a
    dense-equivalent pool (no preemption, no eviction)."""
    bat = _batcher(pcfg, params, n_slots=len(prompts), max_seq=max_seq)
    outs = _run_all(bat, prompts, max_new)
    assert bat.preemptions == 0
    return outs


def _random_pools(cfg, n_pages, page, seed=0):
    pools = tparams.init_params(
        tregistry.paged_cache_decls(cfg, n_pages, page), device="cpu")
    g = torch.Generator().manual_seed(seed)
    for tree in pools.values():
        for a in tparams.tree_leaves(tree):
            if a.dtype == torch.int8:
                a.copy_(torch.randint(-120, 120, a.shape, generator=g))
            else:
                a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    return pools


# --- host store (T1) unit -------------------------------------------------------------


def _entry(lib, val, nbytes):
    if lib == "np":
        return {"kv": {"k": np.full(nbytes // 2, val, np.int8),
                       "v": np.full(nbytes - nbytes // 2, val, np.int8)}}
    return {"kv": {"k": torch.full((nbytes // 2,), val, dtype=torch.int8),
                   "v": torch.full((nbytes - nbytes // 2,), val,
                                   dtype=torch.int8)}}


def test_host_store_budget_and_lru():
    s = HostPageStore(1000)
    assert s.put((1,), _entry("t", 1, 400))
    assert s.put((2,), _entry("t", 2, 400))
    assert s.nbytes == 800 and len(s) == 2
    assert s.put((3,), _entry("t", 3, 400))
    assert s.nbytes <= 1000 and s.evictions == 1
    assert s.get((1,)) is None
    assert s.get((2,)) is not None
    assert s.put((4,), _entry("t", 4, 400))
    assert s.get((3,)) is None and s.get((2,)) is not None
    assert not s.put((5,), _entry("t", 5, 2000))
    assert s.rejected == 1 and s.nbytes <= 1000
    assert s.put((4,), _entry("t", 9, 600))
    assert s.nbytes <= 1000
    assert int(s.get((4,))["kv"]["k"][0]) == 9


def test_host_store_matches_reference_on_seeded_ops():
    """One seeded sequence of put/get/touch against both stores: every
    result, the byte count, evictions, refusals and the final LRU order
    agree."""
    rng = np.random.default_rng(11)
    t, j = HostPageStore(2048), jtiers.HostPageStore(2048)
    for step in range(300):
        op = rng.choice(["put", "put", "get", "touch"])
        key = (int(rng.integers(0, 9)),)
        if op == "put":
            n = int(rng.integers(50, 900)) if step % 37 else 3000
            val = int(rng.integers(-100, 100))
            assert t.put(key, _entry("t", val, n)) == \
                j.put(key, _entry("np", val, n))
        elif op == "get":
            a, b = t.get(key), j.get(key)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a["kv"]["k"].numpy(),
                                              b["kv"]["k"])
        else:
            assert t.touch(key) == j.touch(key)
        assert (t.nbytes, t.evictions, t.rejected, len(t)) == \
            (j.nbytes, j.evictions, j.rejected, len(j))
    assert [k for k, _ in t.items_lru_order()] == \
        [k for k, _ in j.items_lru_order()]
    assert t.evictions > 10 and t.rejected > 0


def test_content_key_and_rolling_match_equal_reference():
    """T1 keys are byte-equal to the reference's for any token container,
    and ``match``'s rolling digest reaches exactly the keys of the
    full-path ``_content_key``."""
    rng = np.random.default_rng(3)
    for toks in ([], [5], list(range(40)),
                 rng.integers(0, 1 << 20, 33).astype(np.int32),
                 rng.integers(0, 50000, 16).astype(np.int64)):
        assert ttiers._content_key(toks) == jtiers._content_key(toks)
        assert len(ttiers._content_key(toks)) == 20
    cfg = tsmoke(tconfigs.get("minitron-4b"))
    m = KVTierManager(get_layout(cfg, 4), 4, 4, 1 << 20,
                      StagedTransferEngine(get_layout(cfg, 4)))
    prompt = rng.integers(0, 1000, 19).astype(np.int32)
    for b in range(3):                               # blocks 0..2 cached
        m.store.put(ttiers._content_key(prompt[:(b + 1) * 4]),
                    {"kv": {"k": torch.full((2,), b, dtype=torch.int8)}})
    assert [int(e["kv"]["k"][0]) for e in m.match(prompt, 0)] == [0, 1, 2]
    assert [int(e["kv"]["k"][0]) for e in m.match(prompt, 1)] == [1, 2]
    assert m.match(prompt, 3) == []


def test_prefix_index_walk_and_matched_blocks():
    for cls in (PrefixIndex, JPrefixIndex):
        idx = cls(["kv"], page=4, block=4)
        idx.insert(np.arange(12, dtype=np.int32), {"kv": [10, 11, 12]})
        branch = np.asarray([0, 1, 2, 3, 9, 9, 9, 9], np.int32)
        idx.insert(branch, {"kv": [20, 21]})
        assert idx.matched_blocks(np.arange(12, dtype=np.int32)) == 3
        assert idx.matched_blocks(branch) == 2
        assert idx.matched_blocks(np.arange(6, dtype=np.int32)) == 1
        assert idx.matched_blocks(np.asarray([7, 7, 7, 7], np.int32)) == 0
        walked = dict(idx.walk())
        assert set(walked) == {(0, 1, 2, 3), (0, 1, 2, 3, 4, 5, 6, 7),
                               tuple(range(12)), (0, 1, 2, 3, 9, 9, 9, 9)}
        assert walked[(0, 1, 2, 3)] == {"kv": [10]}
        assert walked[tuple(range(12))] == {"kv": [12]}


# --- staged transfer engine: dtype preservation --------------------------------------


def test_staged_engine_int8_dtype_roundtrip():
    """Spilled int8 pages come back as int8 with their bf16 scale pages
    intact; a float payload must not cast silently into the int8 pool."""
    cfg = dataclasses.replace(tsmoke(tconfigs.get("minitron-4b")),
                              kv_cache_dtype="int8")
    layout = get_layout(cfg, 8)
    pools = _random_pools(cfg, {"kv": 4}, 8)
    eng = StagedTransferEngine(layout)
    data = eng.gather_host(pools, {"kv": [1, 3]})
    dts = {k: v.dtype for k, v in data["kv"].items()}
    assert dts == {"k": torch.int8, "v": torch.int8,
                   "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    assert all(v.device.type == "cpu" for v in data["kv"].values())
    zero = tparams.tree_map(lambda _, a: torch.zeros_like(a), pools)
    back = eng.scatter_device(zero, data, {"kv": [0, 2]})
    orig = layout.spill(pools, "kv", [1, 3])
    got = layout.spill(back, "kv", [0, 2])
    for k in orig:
        assert torch.equal(orig[k], got[k]), k
    assert eng.d2h_bytes > 0 and eng.h2d_bytes == eng.d2h_bytes
    assert (eng.gathers, eng.scatters) == (1, 1)
    assert eng.gather_host(pools, {"kv": []}) == {} and eng.gathers == 1
    bad = {k: v.float() for k, v in data["kv"].items()}
    with pytest.raises(TypeError, match="dtype"):
        layout.restore_pages(pools, "kv", bad, [0, 2])


def test_snapshot_geometry_mismatch_raises(tmp_path):
    cfg = tsmoke(tconfigs.get("minitron-4b"))
    layout = get_layout(cfg, 8)
    eng = StagedTransferEngine(layout)
    m8 = KVTierManager(layout, 8, 8, 1 << 16, eng)
    m8.store.put((1, 2), {"kv": {"k": torch.zeros(4, dtype=torch.int8)}})
    p = str(tmp_path / "snap.pkl")
    m8.save(p)
    m16 = KVTierManager(get_layout(cfg, 16), 16, 16, 1 << 16,
                        StagedTransferEngine(layout))
    with pytest.raises(ValueError, match="geometry"):
        m16.load(p)
    i8cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    mi8 = KVTierManager(get_layout(i8cfg, 8), 8, 8, 1 << 16,
                        StagedTransferEngine(get_layout(i8cfg, 8)))
    with pytest.raises(ValueError, match="dtype"):
        mi8.load(p)
    assert m8.load(p) == 1          # matching geometry round-trips
    assert "torch.bfloat16" in str(m8._payload_signature())


def test_jax_written_snapshot_is_refused(tmp_path):
    """The port's snapshots are its own format: a snapshot the JAX
    package wrote (numpy / ml_dtypes leaves) fails cleanly instead of
    loading as pages."""
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jl = jget_layout(jcfg, 8)
    jm = jtiers.KVTierManager(jl, 8, 8, 1 << 16,
                              jtiers.StagedTransferEngine(jl))
    jm.store.put(b"k" * 20, {"kv": {"k": np.zeros(4, np.float32)}})
    p = str(tmp_path / "jax.snap")
    jm.save(p)
    cfg = tsmoke(tconfigs.get("minitron-4b"))
    m = KVTierManager(get_layout(cfg, 8), 8, 8, 1 << 16,
                      StagedTransferEngine(get_layout(cfg, 8)))
    with pytest.raises((SnapshotCorruptError, ValueError)):
        m.load(p)
    assert len(m.store) == 0


# --- demote -> rehit: restored pages bit-identical -------------------------------------


def _admit_snapshot(bat, P, max_new, rid):
    """Submit, admit and prefill by hand, then copy the prompt pages'
    bits (every group); the caller finishes with ``bat.run``."""
    r = Request(rid=rid, prompt=P, max_new=max_new)
    bat.submit(r)
    while not bat._admitting:
        bat.admit()
    while bat._admitting:
        bat._prefill_step()
    n = -(-len(P) // bat.page_size)
    slot = next(i for i, rr in enumerate(bat._slot_req) if rr is r)
    snap = {g.name: bat.layout.spill(bat.pools, g.name,
                                     bat._slot_pages[g.name][slot][:n])
            for g in bat.layout.groups}
    return r, snap


def test_demote_rehit_restores_bit_identical_pages(model):
    """A prefix evicted to the host tier and re-admitted serves from
    restored pages whose bits equal the cold run's: tokens identical,
    catch-up chunk only."""
    cfg, params, _, _ = model
    P = _prompt(cfg, 32, seed=40)
    F = _prompt(cfg, 32, seed=41)
    bat = _batcher(_tier_cfg(cfg), params, n_slots=1, max_seq=64,
                   n_pages=6)
    r, cold_snap = _admit_snapshot(bat, P, 4, rid=0)
    bat.run(1)
    cold = drain(r)
    assert cold == _greedy(cfg, params, P, 4)
    (f_out,) = _serve_seq(bat, [F], [4])
    assert f_out == _greedy(cfg, params, F, 4)
    t = bat._tiers.stats()
    assert t["demotions"] >= 3 and t["t1_entries"] >= 3
    chunks_before = bat.prefill_chunks
    r2, hit_snap = _admit_snapshot(bat, P, 4, rid=2)
    assert bat.prefill_chunks - chunks_before == 1
    for g in cold_snap:
        for leaf in cold_snap[g]:
            assert torch.equal(cold_snap[g][leaf], hit_snap[g][leaf]), leaf
    bat.run(bat.retired + 1)
    assert drain(r2) == cold
    assert bat._tiers.stats()["rehits"] >= 1


@pytest.mark.parametrize("kw", [{"sliding_window": 16},
                                {"kv_cache_dtype": "int8"}])
def test_demote_rehit_token_identical_across_layouts(model, kw):
    """demote -> rehit == cold on the flat windowed and the int8 (with
    scale pages) layouts; the oracle is the batcher's own cold run."""
    cfg, params, _, _ = model
    cfg = dataclasses.replace(cfg, **kw)
    P = _prompt(cfg, 32, seed=42)
    F = _prompt(cfg, 32, seed=43)
    bat = _batcher(_tier_cfg(cfg), params, n_slots=1, max_seq=64, n_pages=6)
    cold, f_out, hit = _serve_seq(bat, [P, F, P], [5, 5, 5])
    assert hit == cold
    t = bat._tiers.stats()
    assert t["demotions"] >= 1 and t["rehits"] >= 1


def test_t1_eviction_never_strands_refcounted_pages(model):
    """Under churn the byte budget holds, T1 evicts host bytes only, and
    every device page stays accounted (index holdings == usage)."""
    cfg, params, _, _ = model
    probe = _batcher(_tier_cfg(cfg), params, n_slots=1, max_seq=64,
                     n_pages=6)
    one_block = sum(a.numel() * a.element_size() // a.shape[1]
                    for a in probe.pools["kv"].values())
    bat = _batcher(_tier_cfg(cfg, budget=2 * one_block + 1), params,
                   n_slots=1, max_seq=64, n_pages=6)
    prompts = [_prompt(cfg, 32, seed=50 + i) for i in range(4)]
    outs = _serve_seq(bat, prompts, [4] * 4)
    for p, o in zip(prompts, outs):
        assert o == _greedy(cfg, params, p, 4)
    t = bat._tiers.stats()
    assert t["demotions"] > 0 and t["t1_evictions"] > 0
    assert t["t1_bytes"] <= t["t1_budget_bytes"]
    for alloc in bat._alloc.values():
        assert alloc.used_pages == bat._prefix.n_pages
        assert alloc.used_pages + alloc.free_pages == alloc.n_pages
        assert alloc.shared_pages == 0
        alloc.check_consistency()


# --- T2 snapshots ----------------------------------------------------------------------


def test_snapshot_restart_serves_first_hit_from_catchup_chunk(model,
                                                              tmp_path):
    cfg, params, _, _ = model
    snap = str(tmp_path / "kv_tier.snap")
    sysp = _prompt(cfg, 32, seed=60)
    tcfg = _tier_cfg(cfg, snapshot=snap)
    bat_a = _batcher(tcfg, params, n_slots=2, max_seq=64)
    (cold,) = _serve_seq(bat_a, [sysp], [5])
    assert cold == _greedy(cfg, params, sysp, 5)
    assert bat_a.prefill_chunks == 4
    assert bat_a.save_tier_snapshot() == snap
    assert bat_a._tiers.stats()["demotions"] >= 4
    bat_b = _batcher(tcfg, params, n_slots=2, max_seq=64)
    assert bat_b._tiers.stats()["snapshot_loaded"] >= 4
    (hit,) = _serve_seq(bat_b, [sysp], [5])
    assert hit == cold
    assert bat_b.prefill_chunks == 1                 # catch-up chunk only
    assert bat_b._tiers.stats()["rehits"] >= 1
    for alloc in bat_b._alloc.values():
        assert alloc.used_pages == bat_b._prefix.n_pages
        assert alloc.shared_pages == 0


# --- preemption through the staged engine -------------------------------------------


def test_int8_preempt_spill_dtype_and_bit_identical_resume(model):
    cfg, params, _, _ = model
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompts = [_prompt(cfg, 6, seed=70 + i) for i in range(3)]
    pcfg = _tier_cfg(cfg, page=4, chunk=4, restore_min=0)
    golds = _uncontended(pcfg, params, prompts, 12)
    bat = _batcher(pcfg, params, n_slots=3, max_seq=64, n_pages=8)
    spilled = []
    orig = bat._preempt

    def spy(slot):
        orig(slot)
        rec = bat._preempted[-1]
        if rec.data.get("kv") is not None:
            spilled.append({k: v.dtype for k, v in rec.data["kv"].items()})
    bat._preempt = spy
    assert _run_all(bat, prompts, 12) == golds
    assert bat.preemptions > 0 and bat.resumes > 0
    assert spilled
    for d in spilled:
        assert d == {"k": torch.int8, "v": torch.int8,
                     "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    x = bat._xfer.stats()
    assert x["staged_gathers"] > 0 and x["staged_scatters"] > 0


def test_short_rehit_recomputes_instead_of_restoring(model):
    cfg, params, _, _ = model
    P = _prompt(cfg, 32, seed=80)
    F = _prompt(cfg, 32, seed=81)
    bat = _batcher(_tier_cfg(cfg, restore_min=10_000), params, n_slots=1,
                   max_seq=64, n_pages=6)
    cold, f_out, again = _serve_seq(bat, [P, F, P], [4, 4, 4])
    assert again == cold == _greedy(cfg, params, P, 4)
    t = bat._tiers.stats()
    assert t["demotions"] >= 1
    assert t["recomputes"] >= 1 and t["rehits"] == 0


def test_short_preempted_sequences_resume_by_recompute(model):
    cfg, params, _, _ = model
    prompts = [_prompt(cfg, 6, seed=90 + i) for i in range(3)]
    pcfg = _tier_cfg(cfg, page=4, chunk=4, restore_min=10_000)
    golds = _uncontended(pcfg, params, prompts, 12)
    bat = _batcher(pcfg, params, n_slots=3, max_seq=64, n_pages=8)
    spilled = []
    orig = bat._preempt

    def spy(slot):
        orig(slot)
        spilled.append(any(v is not None
                           for v in bat._preempted[-1].data.values()))
    bat._preempt = spy
    assert _run_all(bat, prompts, 12) == golds
    assert bat.preemptions > 0 and bat.recompute_resumes > 0
    assert bat.recompute_resumes == bat.resumes
    assert spilled and not any(spilled)


def test_tier_disabled_behavior_unchanged(model):
    cfg, params, _, _ = model
    pcfg = dataclasses.replace(cfg, kv_page_size=8, prefix_cache=True)
    bat = _batcher(pcfg, params, n_slots=1, max_seq=64, n_pages=6)
    assert bat._tiers is None
    P = _prompt(cfg, 32, seed=95)
    F = _prompt(cfg, 32, seed=96)
    cold, f_out, again = _serve_seq(bat, [P, F, P], [4, 4, 4])
    assert again == cold == _greedy(cfg, params, P, 4)
    assert bat.prefix_evictions > 0
    st = bat.stats()
    assert "tiers" not in st and "transfers" in st
    assert st["transfers"]["gathers"] == 0


def test_gemma3_preemption_over_both_groups_through_the_engine():
    """gemma3's ring group is not shareable, so the prefix cache and with
    it T1 stay off (as in the reference), while preemption still spills
    and restores both groups through the staged engine, bit-identical to
    the uncontended run."""
    cfg = tsmoke(tconfigs.get("gemma3-12b"))
    params = tregistry.init(cfg, 0, device="cpu")
    pcfg = _tier_cfg(cfg, restore_min=0)
    prompts = [_prompt(cfg, n, seed=7 + n) for n in (10, 21, 14)]
    gold = _uncontended(pcfg, params, prompts, 16, max_seq=48)
    bat = _batcher(pcfg, params, n_slots=3, max_seq=48,
                   n_pages={"local": 5, "global": 7})
    assert not bat.prefix_cache and bat._tiers is None
    assert _run_all(bat, prompts, 16) == gold
    assert bat.preemptions > 0 and bat.resumes == bat.preemptions
    x = bat.stats()["transfers"]
    assert x["gathers"] == bat.preemptions and x["scatters"] > 0
    assert x["d2h_bytes"] > 0
    for alloc in bat._alloc.values():
        assert alloc.used_pages == 0
        alloc.check_consistency()


# --- across frameworks ----------------------------------------------------------------

_TIER_KEYS = ("t1_entries", "t1_bytes", "t1_evictions", "t1_rejected",
              "demotions", "demote_skips", "rehits", "rehit_tokens",
              "recomputes", "snapshot_loaded", "recompute_resumes",
              "gathers", "scatters", "d2h_bytes", "h2d_bytes")


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"}])
def test_tokens_and_tier_counters_match_jax_batcher(model, kw):
    """Demote, rehit and a short-rehit recompute through one live batcher
    on each side: the port streams the JAX batcher's tokens with the
    same tier, transfer and prefix counters."""
    cfg, params, jcfg, jp = model
    extra = dict(kv_page_size=8, prefill_chunk=8, prefix_cache=True,
                 kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=24,
                 **kw)
    P, F = _prompt(cfg, 32, seed=42), _prompt(cfg, 32, seed=43)
    S = np.concatenate([F[:16], _prompt(cfg, 8, seed=44)])
    prompts, max_news = [P, F, P, S], [5, 5, 5, 4]
    jbat = jbatching.ContinuousBatcher(dataclasses.replace(jcfg, **extra),
                                       jp, n_slots=1, max_seq=64, n_pages=6)
    jouts = _serve_seq(jbat, prompts, max_news, req=jbatching.Request,
                       drain_fn=jbatching.drain)
    bat = _batcher(dataclasses.replace(cfg, **extra), params, n_slots=1,
                   max_seq=64, n_pages=6)
    outs = _serve_seq(bat, prompts, max_news)
    assert outs == jouts
    st, jst = bat.stats(), jbat.stats()
    assert {k: st["tiers"][k] for k in _TIER_KEYS} == \
        {k: jst["tiers"][k] for k in _TIER_KEYS}
    keys = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "prefix_evictions", "steps", "prefill_chunks", "preemptions")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["tiers"]["rehits"] >= 1 and st["tiers"]["demotions"] >= 3
    assert st["tiers"]["recomputes"] >= 1
