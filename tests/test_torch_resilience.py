"""Port parity: resilient serving (``serve/resilience.py`` and the
batcher's lifecycle).

The reference's ``tests/test_resilience.py`` cases on the port's paged
and dense batchers (minitron-4b smoke, JAX's weights bridged), each held
to its stated contract: typed terminal events (no consumer hangs: every
drain and join takes a timeout), the seeded ``FaultPlan`` (its fired
ordinals equal the reference's for the same spec and seed, ``@p``
clauses included), step, dense-step and chunk faults, the supervisor's
recovery, restart budget and stall watchdog, snapshot integrity, the
overload and SLA lifecycle under an injected clock, class-rank
preemption, the tier-off rung, allocator invariants and the CLI's flags.
The reference's three spec-decode resilience tests are red there (C2),
so their port twins are held to the contract, not to JAX's outputs:
deadline expiry frees every page, a verify fault unwinds its scratch
pages before dying, and supervised recovery from a verify fault is
bit-identical to plain serving.  The chaos matrix is in
``tests/test_torch_chaos.py``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import resilience as jres
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.kv_tiers import SnapshotCorruptError
from repro_torch.serve.prefix_cache import PageAllocator
from repro_torch.serve.resilience import (CLASS_RANK, BatcherFault,
                                          FaultPlan, InjectedFault,
                                          RequestErrored, RequestExpired,
                                          RequestFailed, RequestRejected,
                                          ServeSupervisor, TerminalEvent)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_SEQ = 64


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp


def _prompt(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _paged_cfg(cfg, **kw):
    base = dict(kv_page_size=8, prefill_chunk=8)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


def _batcher(cfg, params, **kw):
    return ContinuousBatcher(cfg, params, device="cpu", **kw)


def _reqs(cfg, n, max_new=6, plen=12, **kw):
    return [Request(rid=i, prompt=_prompt(cfg, plen, seed=i),
                    max_new=max_new, **kw) for i in range(n)]


def _run(bat, reqs, total=None, expect_raise=None):
    """Submit everything up front (queue_depth >= len(reqs)) and run the
    batcher in this thread, optionally asserting it dies with
    ``expect_raise``."""
    for r in reqs:
        bat.submit(r)
    if expect_raise is None:
        bat.run(total if total is not None else len(reqs))
        return None
    with pytest.raises(expect_raise) as ei:
        bat.run(total if total is not None else len(reqs))
    return ei.value


def _drain_all(reqs, timeout=10.0):
    """Outcomes (tokens, None) or (partial, error), each drain bounded: a
    TimeoutError here is a hung consumer."""
    outs = {}
    for r in reqs:
        try:
            outs[r.rid] = (drain(r, timeout=timeout), None)
        except RequestFailed as e:
            outs[r.rid] = (e.tokens, e)
    return outs


def _gold(cfg, params, reqs_spec, **bkw):
    bat = _batcher(cfg, params, **bkw)
    reqs = [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
            for r in reqs_spec]
    _run(bat, reqs)
    return {r.rid: drain(r, timeout=10.0) for r in reqs}


def _check_allocators(bat):
    for alloc in bat._alloc.values():
        alloc.check_consistency()


# --- FaultPlan -------------------------------------------------------------------------


def test_fault_plan_grammar_and_determinism():
    p = FaultPlan("a:3;b:2+;c:2..4;d:*", seed=1)
    assert [p.fire("a") for _ in range(5)] == [False, False, True,
                                              False, False]
    assert [p.fire("b") for _ in range(4)] == [False, True, True, True]
    assert [p.fire("c") for _ in range(5)] == [False, True, True,
                                              True, False]
    assert all(p.fire("d") for _ in range(3))
    assert not p.fire("unknown")
    assert p.fired["a"] == [3] and p.fired["c"] == [2, 3, 4]
    runs = [[f.fire("x") for _ in range(20)]
            for f in (FaultPlan("x:*@0.5", seed=9),
                      FaultPlan("x:*@0.5", seed=9))]
    assert runs[0] == runs[1] and True in runs[0] and False in runs[0]
    assert runs[0] != [FaultPlan("x:*@0.5", seed=10).fire("x")
                       for _ in range(20)]
    with pytest.raises(ValueError):
        FaultPlan("nocolon")
    assert not FaultPlan("").active
    with pytest.raises(InjectedFault):
        FaultPlan("s:1").check("s")


@pytest.mark.parametrize("spec", [
    "step:3;t1_d2h:1+;alloc:2..5;snapshot_corrupt:1",
    "step:*@0.3;chunk:2+@0.5;alloc:1..40@0.25",
    "t1_h2d:1..3;t1_h2d:7+@0.6;verify:2",
])
@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_fault_plan_fires_on_the_reference_ordinals(spec, seed):
    """The same spec and seed fire on the same call ordinals as the
    reference's plan, over one seeded interleaving of site calls."""
    sites = ["step", "chunk", "alloc", "t1_d2h", "t1_h2d", "verify",
             "snapshot_corrupt", "other"]
    t, j = FaultPlan(spec, seed=seed), jres.FaultPlan(spec, seed=seed)
    order = np.random.default_rng(seed + 1).choice(sites, 400)
    assert [t.fire(s) for s in order] == [j.fire(s) for s in order]
    assert t.fired == j.fired and t._calls == j._calls
    assert sum(map(len, t.fired.values())) > 3


def test_fault_plan_env_resolution(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "env_site:1")
    monkeypatch.setenv("REPRO_FAULT_SEED", "5")
    p = FaultPlan.resolve(None, "cfg_site:1")
    assert p.spec == "env_site:1" and p.seed == 5
    assert FaultPlan.resolve("explicit:1", "cfg_site:1").spec == "explicit:1"
    monkeypatch.delenv("REPRO_FAULTS")
    assert FaultPlan.resolve(None, "cfg_site:1").spec == "cfg_site:1"
    pre = FaultPlan("x:1", seed=3)
    assert FaultPlan.resolve(pre) is pre


# --- error propagation -----------------------------------------------------------------


def test_failing_step_errors_consumers_fast(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ,
                   queue_depth=64, faults="step:2")
    reqs = _reqs(pcfg, 4)
    err = _run(bat, reqs, expect_raise=BatcherFault)
    assert isinstance(err.cause, InjectedFault)
    outs = _drain_all(reqs, timeout=5.0)
    failures = [e for _, e in outs.values() if e is not None]
    assert failures
    for toks, e in outs.values():
        if e is not None:
            assert isinstance(e, RequestErrored) or e.reason.startswith(
                "batcher shut down")
            if isinstance(e, RequestErrored):
                assert isinstance(e.__cause__, InjectedFault)
    st = bat.stats()
    assert st["errored"] + st["cancelled"] == len(failures)


def test_dense_step_fault_also_propagates(model):
    cfg, params = model
    bat = _batcher(cfg, params, n_slots=2, max_seq=32, queue_depth=64,
                   faults="step:1")
    assert not bat.paged
    reqs = _reqs(cfg, 2, plen=8, max_new=4)
    _run(bat, reqs, expect_raise=BatcherFault)
    outs = _drain_all(reqs, timeout=5.0)
    assert all(isinstance(e, RequestErrored) for _, e in outs.values())


def test_chunk_fault_errors_only_affected(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    spec = _reqs(pcfg, 3, plen=20, max_new=5)
    gold = _gold(pcfg, params, spec, n_slots=2, max_seq=MAX_SEQ,
                 queue_depth=64)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=64,
                   faults="chunk:2")
    reqs = _reqs(pcfg, 3, plen=20, max_new=5)
    _run(bat, reqs)                           # chunk faults are not fatal
    outs = _drain_all(reqs)
    errs = {rid: e for rid, (_, e) in outs.items() if e is not None}
    assert len(errs) == 1
    (rid, e), = errs.items()
    assert isinstance(e, RequestErrored)
    assert isinstance(e.__cause__, InjectedFault)
    for r in reqs:
        if r.rid not in errs:
            assert outs[r.rid][0] == gold[r.rid]
    _check_allocators(bat)
    assert bat.stats()["errored"] == 1 and bat.total_used_pages() == 0


# --- supervised crash recovery ---------------------------------------------------------


def test_supervisor_recovers_bit_identical(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg, prefix_cache=True)
    spec = _reqs(pcfg, 4, plen=12, max_new=6)
    gold = _gold(pcfg, params, spec, n_slots=2, max_seq=MAX_SEQ,
                 queue_depth=64)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=64,
                   faults="step:3")
    sup = ServeSupervisor(bat, max_restarts=2)
    reqs = _reqs(pcfg, 4, plen=12, max_new=6)
    for r in reqs:
        bat.submit(r)
    report = sup.run(len(reqs))
    assert report.restarts == 1 and report.faults == 1
    assert report.recovered_requests >= 1
    outs = _drain_all(reqs)
    for r in reqs:
        assert outs[r.rid] == (gold[r.rid], None), r.rid
    assert bat.stats()["restarts"] == 1
    _check_allocators(bat)


def test_supervisor_exhausts_restart_budget(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=64,
                   faults="step:*")
    sup = ServeSupervisor(bat, max_restarts=1)
    reqs = _reqs(pcfg, 2, plen=12, max_new=6)
    for r in reqs:
        bat.submit(r)
    with pytest.raises(BatcherFault) as ei:
        sup.run(len(reqs))
    assert isinstance(ei.value.cause, InjectedFault)
    assert sup.report.restarts == 1
    outs = _drain_all(reqs, timeout=5.0)
    assert all(e is not None for _, e in outs.values())


def test_stall_watchdog_triggers_supervised_restart(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    spec = _reqs(pcfg, 2, plen=12, max_new=5)
    gold = _gold(pcfg, params, spec, n_slots=2, max_seq=MAX_SEQ,
                 queue_depth=64)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=64)
    sup = ServeSupervisor(bat, max_restarts=2)
    bat._stalled = True                  # what the watchdog would set
    reqs = _reqs(pcfg, 2, plen=12, max_new=5)
    for r in reqs:
        bat.submit(r)
    report = sup.run(len(reqs))
    assert report.restarts == 1
    outs = _drain_all(reqs)
    for r in reqs:
        assert outs[r.rid] == (gold[r.rid], None)


def test_watchdog_flags_a_silent_heartbeat(model):
    """The monitor thread itself: with a fake clock past the heartbeat
    window it sets the batcher's stall flag, and stops when asked."""
    cfg, params = model
    bat = _batcher(_paged_cfg(cfg), params, n_slots=1, max_seq=MAX_SEQ)
    now = [0.0]
    sup = ServeSupervisor(bat, heartbeat_timeout=0.2, clock=lambda: now[0])
    assert bat._heartbeat is sup.heartbeat and bat._supervised
    now[0] = 5.0
    stop = threading.Event()
    th = threading.Thread(target=sup._watch, args=(stop,), daemon=True)
    th.start()
    for _ in range(100):
        if bat._stalled:
            break
        threading.Event().wait(0.02)
    stop.set()
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert bat._stalled and sup.report.stalls >= 1


# --- snapshot integrity ----------------------------------------------------------------


def _tier_cfg(cfg, snapshot, faults=""):
    return _paged_cfg(cfg, prefix_cache=True, kv_host_tier_bytes=1 << 20,
                      tier_restore_min_tokens=0, kv_tier_snapshot=snapshot,
                      fault_plan=faults)


def _serve_one(pcfg, params, prompt, max_new=5):
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=8)
    r = Request(rid=0, prompt=prompt, max_new=max_new)
    _run(bat, [r])
    drain(r, timeout=10.0)
    return bat


@pytest.mark.parametrize("mangle", ["snapshot_corrupt", "snapshot_truncate"])
def test_snapshot_corruption_degrades_to_cold_start(model, tmp_path, mangle):
    cfg, params = model
    snap = str(tmp_path / "kv.snap")
    prompt = _prompt(cfg, 16, seed=3)
    bat = _serve_one(_tier_cfg(cfg, snap, faults=f"{mangle}:1"), params,
                     prompt)
    bat.save_tier_snapshot()
    with pytest.raises(SnapshotCorruptError):
        bat._tiers.load(snap)
    with pytest.warns(UserWarning, match="cold start"):
        bat2 = _batcher(_tier_cfg(cfg, snap), params, n_slots=2,
                        max_seq=MAX_SEQ, queue_depth=8)
    assert bat2.snapshot_cold_start
    assert bat2.stats()["snapshot_cold_start"]
    assert bat2._tiers is not None and len(bat2._tiers.store) == 0
    r = Request(rid=1, prompt=prompt, max_new=5)
    _run(bat2, [r])
    assert len(drain(r, timeout=10.0)) == 5


def test_snapshot_checksum_roundtrip(model, tmp_path):
    cfg, params = model
    snap = str(tmp_path / "kv.snap")
    prompt = _prompt(cfg, 24, seed=4)
    bat = _serve_one(_tier_cfg(cfg, snap), params, prompt)
    bat.save_tier_snapshot()
    bat2 = _batcher(_tier_cfg(cfg, snap), params, n_slots=2,
                    max_seq=MAX_SEQ, queue_depth=8)
    assert not bat2.snapshot_cold_start
    assert bat2._tiers.stats()["snapshot_loaded"] >= 1


# --- overload + SLA lifecycle ----------------------------------------------------------


def test_submit_queue_policy_reject(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=2,
                   overload="reject")
    reqs = _reqs(pcfg, 4, plen=8, max_new=4)
    assert [bat.submit(r) for r in reqs] == [True, True, False, False]
    assert bat.stats()["rejections"] == {"queue_full": 2}
    assert bat.retired == 0                   # shed != retired
    for r in reqs[2:]:
        with pytest.raises(RequestRejected, match="queue_full"):
            drain(r, timeout=2.0)
    bat.run(2)
    assert all(len(drain(r, timeout=10.0)) == 4 for r in reqs[:2])


def test_submit_invalid_pushes_typed_event(model):
    cfg, params = model
    bat = _batcher(_paged_cfg(cfg), params, n_slots=2, max_seq=32)
    bad = Request(rid=9, prompt=_prompt(cfg, 40), max_new=4)
    with pytest.raises(ValueError):
        bat.submit(bad)
    with pytest.raises(RequestRejected, match="invalid"):
        drain(bad, timeout=2.0)
    assert list(bat.stats()["rejections"]) == [
        "invalid: prompt length 40 >= max_seq - 1 (31); no decode "
        "budget left"]


def test_deadline_expiry_queue_and_inflight(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    fake = [100.0]       # nonzero epoch: submitted_at == 0.0 is unstamped
    bat = _batcher(pcfg, params, n_slots=1, max_seq=MAX_SEQ, queue_depth=8,
                   clock=lambda: fake[0])
    r0 = Request(rid=0, prompt=_prompt(cfg, 8, 0), max_new=6)
    r1 = Request(rid=1, prompt=_prompt(cfg, 8, 1), max_new=6,
                 deadline_ms=50.0)
    bat.submit(r0)
    bat.submit(r1)
    fake[0] = 101.0                           # 1000 ms pass "instantly"
    bat.run(2)
    assert len(drain(r0, timeout=10.0)) == 6
    with pytest.raises(RequestExpired):
        drain(r1, timeout=2.0)
    assert bat.stats()["expired"] == 1
    _check_allocators(bat)
    r2 = Request(rid=2, prompt=_prompt(cfg, 8, 2), max_new=30,
                 deadline_ms=500.0)
    bat.submit(r2)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    for _ in range(3):
        bat.step()
    fake[0] += 10.0
    bat.step()
    with pytest.raises(RequestExpired) as ei:
        drain(r2, timeout=2.0)
    assert len(ei.value.tokens) >= 1          # partial prefix delivered
    assert bat._slot_req == [None]
    assert bat.total_used_pages() == 0        # expiry freed the pages
    _check_allocators(bat)


def test_sla_schedule_and_shedding(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    fake = [0.0]
    bat = _batcher(pcfg, params, n_slots=1, max_seq=MAX_SEQ, queue_depth=8,
                   schedule="sla", clock=lambda: fake[0])
    order = []
    b0 = Request(rid=0, prompt=_prompt(cfg, 8, 0), max_new=4, klass="batch")
    b1 = Request(rid=1, prompt=_prompt(cfg, 8, 1), max_new=4, klass="batch")
    lat = Request(rid=2, prompt=_prompt(cfg, 8, 2), max_new=4,
                  klass="latency")
    for r in (b0, b1, lat):                   # latency submitted LAST
        bat.submit(r)
    threads = [threading.Thread(
        target=lambda r=r: (drain(r, timeout=30.0), order.append(r.rid)))
        for r in (b0, b1, lat)]
    for t in threads:
        t.start()
    bat.run(3)
    for t in threads:
        t.join(timeout=30.0)
    assert order[0] == 2, f"latency class must finish first, got {order}"
    bat2 = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=8,
                    schedule="sla", clock=lambda: fake[0])
    bat2._ewma_step_s = 1.0                   # 1 s/step projected
    filler = Request(rid=10, prompt=_prompt(cfg, 8, 3), max_new=20)
    shed = Request(rid=11, prompt=_prompt(cfg, 8, 4), max_new=4,
                   klass="batch", deadline_ms=1.0)
    bat2.submit(filler)
    bat2.submit(shed)
    bat2.run(2)
    assert len(drain(filler, timeout=10.0)) == 20
    with pytest.raises(RequestRejected, match="deadline_unmeetable"):
        drain(shed, timeout=2.0)
    assert bat2.stats()["rejections"] == {"deadline_unmeetable": 1}


def test_class_rank_drives_preemption(model):
    """Under pool pressure the batch-class slot is preempted, never the
    latency-class one, even though the latency request was admitted
    last (the plain tie-break would pick it)."""
    cfg, params = model
    pcfg = _paged_cfg(cfg)
    bat = _batcher(pcfg, params, n_slots=2, max_seq=MAX_SEQ, queue_depth=8,
                   n_pages=6)
    batch = Request(rid=1, prompt=_prompt(cfg, 16, 1), max_new=12,
                    klass="batch")
    lat = Request(rid=0, prompt=_prompt(cfg, 16, 0), max_new=12,
                  klass="latency")
    bat.submit(batch)
    bat.submit(lat)
    bat.run(2)
    assert len(drain(lat, timeout=10.0)) == 12
    assert len(drain(batch, timeout=10.0)) == 12
    assert bat.preempted_rids and 0 not in bat.preempted_rids
    _check_allocators(bat)


# --- tier degradation ladder -----------------------------------------------------------


def test_repeated_tier_faults_disable_tier(model):
    cfg, params = model
    pcfg = _paged_cfg(cfg, prefix_cache=True, kv_host_tier_bytes=1 << 20,
                      tier_restore_min_tokens=0)
    # 8 pages: the fourth admission evicts cached prefixes, and every
    # demotion takes the t1_d2h fault.
    kw = dict(n_slots=2, max_seq=MAX_SEQ, queue_depth=64, n_pages=8)
    spec = _reqs(pcfg, 4, plen=16, max_new=6)
    gold = _gold(pcfg, params, spec, **kw)
    bat = _batcher(pcfg, params, faults="t1_d2h:1+", tier_fault_limit=2,
                   **kw)
    reqs = _reqs(pcfg, 4, plen=16, max_new=6)
    with pytest.warns(UserWarning, match="tier"):
        _run(bat, reqs)
    outs = _drain_all(reqs)
    for r in reqs:
        assert outs[r.rid] == (gold[r.rid], None)
    st = bat.stats()
    assert st["tier_faults"] >= 2
    assert st["tier_disabled"] and bat._tiers is None
    _check_allocators(bat)


# --- allocator invariants --------------------------------------------------------------


def test_allocator_check_consistency():
    a = PageAllocator(8)
    pages = a.alloc(3)
    a.incref(pages[:1])
    a.check_consistency()
    a.free(pages)
    a.free(pages[:1])
    a.check_consistency()
    assert a.free_pages == 8
    a._free.append(2)                         # corrupt: duplicate free
    with pytest.raises(AssertionError):
        a.check_consistency()


def test_class_rank_table():
    assert CLASS_RANK == jres.CLASS_RANK
    assert CLASS_RANK["latency"] > CLASS_RANK["standard"] > \
        CLASS_RANK["batch"]
    ev = TerminalEvent.rejected(5, "why")
    err = ev.to_error([1, 2])
    assert isinstance(err, RequestRejected)
    assert err.rid == 5 and err.tokens == [1, 2]
    cause = ValueError("boom")
    err = TerminalEvent.errored(3, cause).to_error()
    assert isinstance(err, RequestErrored) and err.__cause__ is cause
    assert err.reason == "ValueError: boom"


# --- the three spec-decode contracts (red in the reference, C2) ------------------------


def _repetitive_prompts(plens):
    motif = np.asarray([7, 3, 11, 5], np.int32)
    return [np.tile(motif, L // 4 + 1)[:L].astype(np.int32) for L in plens]


SPEC_SEQ = 32


def _spec_cfg(cfg, k=4):
    return _paged_cfg(cfg, speculate_k=k, speculate_ngram=1)


def _plain(cfg, params, prompts, max_news):
    bat = _batcher(_paged_cfg(cfg), params, n_slots=2, max_seq=SPEC_SEQ)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    _run(bat, reqs)
    return [drain(r, timeout=10.0) for r in reqs]


def _oracle_drafts(bat, plain):
    """Draft from the plain run's own continuation, so verify rounds
    commit tokens (the smoke model's greedy text rarely repeats itself,
    which leaves the n-gram drafter idle): the contracts below are about
    the speculative step's bookkeeping, not the drafter."""
    def draft(slot):
        r = bat._slot_req[slot]
        done = bat._host_pos[slot] - len(r.prompt) + 1
        cap = min(bat.speculate_k, bat._host_remaining[slot] - 1)
        return list(plain[r.rid][done:done + cap]) if cap > 0 else []
    bat._draft = draft


def test_spec_deadline_expiry_frees_everything(model):
    cfg, params = model
    prompts = _repetitive_prompts([9, 12])
    plain = _plain(cfg, params, prompts, [16, 16])
    fake = [100.0]
    bat = _batcher(_spec_cfg(cfg), params, n_slots=2, max_seq=SPEC_SEQ,
                   clock=lambda: fake[0])
    _oracle_drafts(bat, plain)
    live = Request(rid=0, prompt=prompts[0], max_new=16)
    dying = Request(rid=1, prompt=prompts[1], max_new=16, deadline_ms=500.0)
    bat.submit(live)
    bat.submit(dying)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    for _ in range(3):
        bat.step()                         # speculative rounds, both alive
    fake[0] += 10.0                        # 10 000 ms pass: dying expires
    bat.run(2)
    assert drain(live, timeout=10.0) == plain[0]
    with pytest.raises(RequestExpired) as ei:
        drain(dying, timeout=2.0)
    assert len(ei.value.tokens) >= 1
    assert ei.value.tokens == plain[1][:len(ei.value.tokens)]
    assert bat.stats()["expired"] == 1
    assert bat.stats()["speculation"]["accepted"] > 0
    assert bat.total_used_pages() == 0
    _check_allocators(bat)


def test_verify_fault_unwinds_scratch_before_dying(model):
    cfg, params = model
    bat = _batcher(_spec_cfg(cfg), params, n_slots=2, max_seq=SPEC_SEQ,
                   faults="verify:2")
    prompts = _repetitive_prompts([9, 12])
    _oracle_drafts(bat, _plain(cfg, params, prompts, [12, 12]))
    reqs = [Request(rid=i, prompt=p, max_new=12)
            for i, p in enumerate(prompts)]
    held = []
    orig = bat._spec_unwind

    def spy(swaps):
        held.append({n: a.used_pages for n, a in bat._alloc.items()})
        orig(swaps)
        held.append({n: a.used_pages for n, a in bat._alloc.items()})
    bat._spec_unwind = spy
    for r in reqs:
        bat.submit(r)
    with pytest.raises(BatcherFault):
        bat.run(2)
    for r in reqs:
        with pytest.raises(RequestErrored):
            drain(r, timeout=2.0)
    assert len(held) == 2 and held[0]["kv"] > held[1]["kv"]   # scratch freed
    slot_pages = sum(len(p) for p in bat._slot_pages["kv"])
    assert bat._alloc["kv"].used_pages == slot_pages
    _check_allocators(bat)


def test_supervised_recovery_from_verify_fault_is_bit_identical(model):
    cfg, params = model
    prompts = _repetitive_prompts([9, 12])
    plain = _plain(cfg, params, prompts, [12, 12])
    bat = _batcher(_spec_cfg(cfg), params, n_slots=2, max_seq=SPEC_SEQ,
                   faults="verify:2")
    _oracle_drafts(bat, plain)
    sup = ServeSupervisor(bat)
    reqs = [Request(rid=i, prompt=p, max_new=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        bat.submit(r)
    sup.run(len(reqs))
    assert [drain(r, timeout=10.0) for r in reqs] == plain
    assert sup.report.restarts >= 1
    assert bat.stats()["speculation"]["accepted"] > 0
    _check_allocators(bat)


# --- the CLI ---------------------------------------------------------------------------


def _cli(*args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_FAULTS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "minitron-4b", "--smoke", "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)


def test_cli_tiers_faults_and_supervisor(tmp_path):
    snap = str(tmp_path / "cli.snap")
    out = _cli("--page-size", "8", "--pages", "12", "--prompt-len", "24",
               "--max-seq", "64", "--prefix-cache", "--shared-prefix", "16",
               "--host-tier-bytes", "1048576", "--tier-restore-min", "8",
               "--tier-snapshot", snap, "--faults", "step:3", "--supervise",
               "--schedule", "sla", "--overload", "block", "--queue-depth",
               "16", "--klass", "latency", "--deadline-ms", "600000")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("req ") for ln in lines) == 8
    assert not any("Request" in ln for ln in lines if ln.startswith("req "))
    assert any(ln.startswith("kv tiers: T1") for ln in lines)
    assert f"kv tiers: snapshot saved to {snap}" in lines
    assert any(ln.startswith("resilience:") and "supervisor restarts 1"
               in ln for ln in lines)
    assert lines[-1].startswith("8 requests, 128 tokens in")
    assert os.path.exists(snap)


@pytest.mark.parametrize("args,msg", [
    (("--page-size", "8", "--tier-snapshot", "x.snap"),
     "--tier-snapshot needs the host tier"),
    (("--page-size", "8", "--host-tier-bytes", "1024"),
     "--host-tier-bytes needs --prefix-cache"),
    (("--schedule", "lifo"), "invalid choice"),
    (("--klass", "gold"), "invalid choice"),
])
def test_cli_argument_errors(args, msg):
    out = _cli(*args)
    assert out.returncode == 2
    assert msg in out.stderr
