"""Port parity: the paged continuous batcher.

* Across frameworks: the port's ``ContinuousBatcher`` with
  ``decode_flash=True, kv_page_size=8`` streams the same tokens as the
  JAX batcher on the same (carried-across) weights.
* Inside the port: paged == dense token for token — the port's
  ``greedy_generate`` over dense slot caches is the oracle — under page
  backpressure, chunked prefill of long prompts, and a pool small enough
  to force preemption and resume; plus the allocator, admission and
  retire invariants of ``tests/test_paged_kv.py``.
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                        RequestFailed, drain)
from repro_torch.serve.prefix_cache import PageAllocator
from repro_torch.serve.serve_loop import greedy_generate

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _prompts(plens, vocab=512):
    return [np.random.default_rng(L).integers(0, vocab, L).astype(np.int32)
            for L in plens]


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=32, **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=60)
    assert not prod.is_alive()
    return [drain(r) for r in reqs], bat


def _gold(cfg, params, prompts, max_news, max_seq=32):
    return [list(greedy_generate(cfg, params, {"tokens": p[None]}, steps=m,
                                 max_seq=max_seq, device="cpu")[0])
            for p, m in zip(prompts, max_news)]


def _paged(cfg, page=8, **kw):
    return dataclasses.replace(cfg, kv_page_size=page, **kw)


def test_batcher_matches_jax_batcher_with_decode_flash(model):
    """Same weights, same prompts: the port's paged batcher through its
    decode kernel twin streams the JAX paged batcher's tokens (the JAX
    Pallas kernel in interpret mode)."""
    cfg, tp, jcfg, jp = model
    plens, max_news = [8, 5, 11], [4, 6, 3]
    prompts = _prompts(plens)
    jbat = jbatching.ContinuousBatcher(
        dataclasses.replace(jcfg, kv_page_size=8, decode_flash=True), jp,
        n_slots=2, max_seq=32)
    jreqs = [jbatching.Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [jbat.submit(r) for r in jreqs])
    prod.start()
    jbat.run(len(jreqs))
    prod.join(timeout=60)
    gold = [jbatching.drain(r) for r in jreqs]
    got, bat = _run(_paged(cfg, decode_flash=True), tp, prompts, max_news)
    assert got == gold
    assert bat.steps == jbat.steps
    assert bat.prefill_chunks == jbat.prefill_chunks


@pytest.mark.parametrize("decode_flash", [False, True])
def test_paged_matches_dense_token_for_token(model, decode_flash):
    """Paged output == dense greedy for every request, including under
    page-pool backpressure (pool smaller than dense-equivalent)."""
    cfg, tp, _, _ = model
    plens = [8, 5, 11, 3, 9, 6]
    max_news = [4, 7, 2, 5, 3, 6]
    prompts = _prompts(plens)
    gold = _gold(cfg, tp, prompts, max_news)
    got, bat = _run(_paged(cfg, decode_flash=decode_flash), tp, prompts,
                    max_news, n_pages=6)
    assert got == gold
    assert bat.total_used_pages() == 0


def test_chunked_prefill_long_prompt_equivalence(model):
    """A prompt spanning several chunks produces exactly the greedy
    tokens, and the chunk counter reflects ceil(plen/chunk)."""
    cfg, tp, _, _ = model
    prompts = _prompts([40])
    gold = _gold(cfg, tp, prompts, [5], max_seq=64)
    got, bat = _run(_paged(cfg, decode_flash=True), tp, prompts, [5],
                    max_seq=64, prefill_chunk=16)
    assert got == gold
    assert bat.prefill_chunks == math.ceil(40 / 16)


@pytest.mark.parametrize("decode_flash", [False, True])
def test_lazy_growth_preempt_resume_token_identical(model, decode_flash):
    """A pool too small for both decodes forces preemption mid-decode;
    spill/restore is bit-identical, so every request still produces its
    uncontended tokens, and the allocator ends consistent."""
    cfg, tp, _, _ = model
    prompts = _prompts([8, 8])
    gold = _gold(cfg, tp, prompts, [8, 8])
    # full need = ceil(16/4) = 4 pages/request; prompts need 2 each.
    got, bat = _run(_paged(cfg, page=4, decode_flash=decode_flash), tp,
                    prompts, [8, 8], n_pages=5)
    assert bat.preemptions > 0 and bat.resumes > 0
    assert got == gold
    assert bat.total_used_pages() == 0
    for name, alloc in bat._alloc.items():
        assert alloc.free_pages == bat.n_pages[name]
        alloc.check_consistency()
    for name, tab in bat.block_tab.items():
        assert int(tab.min()) == bat.n_pages[name]


def test_priority_picks_preemption_victim(model):
    cfg, tp, _, _ = model
    prompts = _prompts([8, 8])
    golds = _gold(cfg, tp, prompts, [8, 8])
    bat = ContinuousBatcher(_paged(cfg, page=4), tp, n_slots=2, max_seq=32,
                            n_pages=5, device="cpu")
    lo = Request(rid=0, prompt=prompts[0], max_new=8, priority=0)
    hi = Request(rid=1, prompt=prompts[1], max_new=8, priority=1)
    bat.submit(lo)
    bat.submit(hi)
    bat.run(2)
    assert [drain(lo), drain(hi)] == golds
    assert bat.preemptions > 0
    assert set(bat.preempted_rids) == {0}


def test_out_of_pages_admission_backpressure(model):
    """A request that cannot get pages WAITS in the FIFO and admits once
    a retire frees its pages."""
    cfg, tp, _, _ = model
    prompts = _prompts([8, 8, 8])
    gold = _gold(cfg, tp, prompts, [8, 8, 8])
    got, bat = _run(_paged(cfg), tp, prompts, [8, 8, 8], n_pages=3)
    assert got == gold
    assert bat.retired == 3 and bat.total_used_pages() == 0


def test_unservable_request_rejected_not_deadlocked(model):
    cfg, tp, _, _ = model
    prompts = _prompts([20, 6])
    bat = ContinuousBatcher(_paged(cfg), tp, n_slots=2, max_seq=32,
                            n_pages=2, device="cpu")
    reqs = [Request(rid=0, prompt=prompts[0], max_new=8),
            Request(rid=1, prompt=prompts[1], max_new=4)]
    for r in reqs:
        bat.submit(r)
    bat.run(2)
    with pytest.raises(RequestFailed, match="unservable") as ei:
        drain(reqs[0])
    assert ei.value.tokens == []
    assert len(drain(reqs[1])) == 4
    assert bat.stats()["rejections"] == {"unservable": 1}


def test_block_table_correct_after_retire_then_reuse(model):
    """Many requests cycling through one slot (pages freed and
    immediately reallocated) all reproduce their greedy outputs."""
    cfg, tp, _, _ = model
    prompts = _prompts([9, 4, 12, 7, 10])
    golds = _gold(cfg, tp, prompts, [4] * 5)
    got, bat = _run(_paged(cfg, decode_flash=True), tp, prompts, [4] * 5,
                    n_slots=1, n_pages=4)
    assert got == golds
    assert bat.total_used_pages() == 0
    for name, tab in bat.block_tab.items():
        assert int(tab.min()) == bat.n_pages[name]


def test_lazy_growth_stays_within_dense_budget(model):
    cfg, tp, _, _ = model
    prompts = _prompts([8, 5, 11, 3, 9, 6])
    _, bat = _run(_paged(cfg), tp, prompts, [4, 7, 2, 5, 3, 6])
    dense_budget = sum(bat.n_slots * nb for nb in bat.n_blocks.values())
    assert 0 < bat.peak_pages < dense_budget
    assert bat.total_used_pages() == 0


def test_chunked_admission_interleaves_with_decode(model):
    """While a long prompt is chunk-prefilling, the active slot keeps
    emitting tokens between chunks."""
    cfg, tp, _, _ = model
    bat = ContinuousBatcher(_paged(cfg), tp, n_slots=2, max_seq=64,
                            prefill_chunk=8, prefill_interleave=1,
                            device="cpu")
    short = Request(rid=0, prompt=_prompts([4])[0], max_new=10)
    long_r = Request(rid=1, prompt=_prompts([40])[0], max_new=2)
    bat.submit(short)
    bat.admit()
    bat._prefill_step()
    assert bat._slot_req[0] is short
    bat.submit(long_r)
    bat.admit()
    assert len(bat._admitting) == 1
    between = []
    while bat._admitting:
        before = bat.steps
        bat.step()
        bat._prefill_step()
        between.append(bat.steps - before)
    assert len(between) == 5 and all(n >= 1 for n in between)
    bat.run(2)
    assert len(drain(short)) == 10 and len(drain(long_r)) == 2


def test_submit_rejects_degenerate_requests(model):
    cfg, tp, _, _ = model
    bat = ContinuousBatcher(_paged(cfg), tp, n_slots=2, max_seq=32,
                            device="cpu")
    with pytest.raises(ValueError, match="max_new"):
        bat.submit(Request(rid=0, prompt=_prompts([4])[0], max_new=1))
    with pytest.raises(ValueError, match="prompt length"):
        bat.submit(Request(rid=1, prompt=_prompts([31])[0], max_new=4))
    r = Request(rid=2, prompt=_prompts([4])[0], max_new=0)
    with pytest.raises(ValueError):
        bat.submit(r)
    with pytest.raises(RequestFailed, match="invalid"):
        drain(r)


@pytest.mark.parametrize("kw", [
    {"tier_snapshot": "x"}, {"host_tier_bytes": 1 << 20},
    {"schedule": "sla"}, {"faults": "step:1"}, {"telemetry": object()},
    {"queue_depth": 4}, {"cfg": {"mesh_shape": (2,)}},
    {"cfg": {"fault_plan": "step:1"}}, {"cfg": {"kv_reserve_decode": True}},
    {"cfg": {"serve_overload": "reject"}},
])
def test_later_slice_options_raise(model, kw):
    """Options of slices still to come (telemetry, reserve-at-admission,
    mesh sharding) raise; the tiers' and resilience's are accepted and
    reach the batcher."""
    cfg, tp, _, _ = model
    kw = dict(kw)
    cf = kw.pop("cfg", {})
    c = dataclasses.replace(_paged(cfg), **cf)
    if "telemetry" in kw or {"mesh_shape", "kv_reserve_decode"} & set(cf):
        with pytest.raises(NotImplementedError):
            ContinuousBatcher(c, tp, n_slots=2, max_seq=32, device="cpu",
                              **kw)
        return
    bat = ContinuousBatcher(c, tp, n_slots=2, max_seq=32, device="cpu",
                            **kw)
    assert bat.paged and bat._tiers is None      # no prefix cache: no T1
    assert bat.schedule == kw.get("schedule", "fifo")
    assert bat.overload == cf.get("serve_overload", "block")
    assert bat.requests.depth == kw.get("queue_depth", 4)
    assert bat._fault.spec == kw.get("faults", cf.get("fault_plan", ""))


def test_unknown_keyword_is_a_type_error(model):
    cfg, tp, _, _ = model
    with pytest.raises(TypeError):
        ContinuousBatcher(_paged(cfg), tp, n_slots=2, max_seq=32,
                          device="cpu", no_such_option=1)


def test_spill_restore_roundtrip_bit_identical(model):
    cfg, tp, _, _ = model
    bat = ContinuousBatcher(_paged(cfg), tp, n_slots=2, max_seq=32,
                            device="cpu")
    pools = bat.pools
    for leaf in pools["kv"].values():
        leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype))
    data = bat.layout.spill(pools, "kv", [1, 3])
    assert data["k"].dtype == torch.bfloat16 and data["k"].shape[1] == 2
    bat.layout.restore(pools, "kv", data, [5, 0])
    assert torch.equal(pools["kv"]["k"][:, 5], pools["kv"]["k"][:, 1])
    assert torch.equal(pools["kv"]["v"][:, 0], pools["kv"]["v"][:, 3])
    with pytest.raises(TypeError, match="dtype"):
        bat.layout.restore(pools, "kv", {k: v.float()
                                         for k, v in data.items()}, [2, 4])
    on_device = bat.layout.gather_pages(pools, "kv", [5])
    assert on_device["k"].device == pools["kv"]["k"].device
    assert torch.equal(on_device["k"][:, 0], pools["kv"]["k"][:, 1])


def test_allocator_alloc_free_reuse_invariants():
    a = PageAllocator(8)
    p1 = a.alloc(3)
    p2 = a.alloc(4)
    assert len(set(p1) | set(p2)) == 7
    assert a.free_pages == 1 and a.used_pages == 7
    assert a.alloc(2) is None
    assert a.free_pages == 1 and a.used_pages == 7
    a.free(p1)
    with pytest.raises(ValueError):
        a.free(p1)
    p3 = a.alloc(4)
    assert p3 is not None and set(p3) & set(p1)
    a.free(p2)
    a.free(p3)
    assert a.free_pages == 8 and a.used_pages == 0
    a.check_consistency()
    full = a.alloc(8)
    assert a.alloc(1) is None
    a.free(full)
    assert a.alloc(8) is not None
