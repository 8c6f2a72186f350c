"""Port parity: serving telemetry (``serve/telemetry.py``) and its hooks in
the port's batcher, transfer engine and supervisor.

The reference's ``tests/test_telemetry.py`` on the port.  The metric,
exposition and tracer code is stdlib on both sides, so the port's
histograms, quantiles and exposition text are held to the reference
module's on the same seeded samples.  The batcher cases run the port
(minitron-4b smoke, JAX's weights bridged): trace stitching across a
supervised crash recovery, the stats alias keys, the transfer engine's
clock, telemetry off == on bit for bit (paged prefix + speculation,
dense slots, int8 pages with preemption) and the profiler ranges around
the three serving steps.  The reference's lifecycle test is red there
(ROADMAP C2), so its twin here is held to its own trace: a single-thread
run under a power-of-two tick clock (every stamp, span and sum exact),
speculation driven by a drafter that proposes the plain run's tokens;
TTFT, chunk times, inter-token gaps and acceptance rebuilt from the JSONL
alone equal the histograms and counters exactly.  The event sequence
against the JAX batcher is in ``tests/test_torch_telemetry_events.py``.
"""

import dataclasses
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import telemetry as jtel
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.core.health import Heartbeat
from repro_torch.models import params as tparams
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve import telemetry as ptel
from repro_torch.serve.resilience import ServeSupervisor
from repro_torch.serve.telemetry import (ENGINE_RID, Histogram,
                                         MetricsRegistry, MetricsServer,
                                         ServeTelemetry, Tracer,
                                         parse_exposition, percentile,
                                         percentiles, validate_exposition)

torch.set_num_threads(2)

PAGE = 8
# a power-of-two tick from a power-of-two start: every stamp, span and
# sum of spans is exact in float64, so the trace rebuilds to the bit.
TICK = 2.0 ** -10
START = 128.0


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp


def _tick_clock(start=START, dt=TICK):
    """Auto-advancing clock: every read moves time on by ``dt``."""
    t = [start]

    def clk():
        t[0] += dt
        return t[0]

    return clk


def _motif_prompt(n):
    motif = np.asarray([7, 3, 11, 5], np.int32)
    return np.tile(motif, n // 4 + 1)[:n].astype(np.int32)


def _batcher(cfg, params, **kw):
    return ContinuousBatcher(cfg, params, device="cpu", **kw)


# --- the stdlib layer, held to the reference module ------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 100])
def test_percentile_matches_numpy_and_reference(n):
    xs = np.random.default_rng(n).exponential(1.0, n).tolist()
    for q in (0, 10, 50, 90, 99, 100):
        assert percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
        assert percentile(xs, q) == jtel.percentile(xs, q)
    qs = (0, 50, 90, 99)
    assert percentiles(xs, qs) == jtel.percentiles(xs, qs)
    assert percentiles([1, 2, 3, 4, 5], (50, 90)) == (3.0,
                                                      pytest.approx(4.6))
    with pytest.raises(ValueError):
        percentile([], 50)


@pytest.mark.parametrize("buckets", [None, (1.0, 2.0, 4.0)])
def test_histogram_quantiles_match_reference(buckets):
    """Seeded samples (some past the last bound) into both histograms:
    the same buckets, counts, sums and bucket-derived quantiles."""
    rng = np.random.default_rng(3)
    xs = rng.lognormal(-5.0 if buckets is None else 0.3, 2.0, 500)
    h = Histogram("t", buckets=buckets)
    ref = jtel.Histogram("t", buckets=buckets)
    for v in xs:
        h.observe(v)
        ref.observe(v)
    assert h.bounds == ref.bounds and h.counts == ref.counts
    assert h.count == ref.count == 500 and h.sum == ref.sum
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == ref.quantile(q)
    assert h.summary() == ref.summary()


def test_histogram_buckets_and_quantiles():
    h = Histogram("t", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0):
        h.observe(v)
    assert h.count == 3 and h.sum == pytest.approx(5.0)
    assert h.counts == [1, 1, 1]
    assert h.quantile(0.5) == pytest.approx(1.5)
    h.observe(100.0)                       # +Inf bucket: last bound
    assert h.count == 4 and sum(h.counts) == 3
    assert h.quantile(0.999) == pytest.approx(4.0)


def test_histogram_empty_and_validation():
    h = Histogram("t", buckets=(1.0, 2.0))
    assert math.isnan(h.quantile(0.5))
    assert h.summary()["count"] == 0
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(2.0, 1.0))


def test_registry_kind_conflict_and_labels():
    reg = MetricsRegistry()
    c = reg.counter("serve_x_total", "x")
    assert reg.counter("serve_x_total") is c
    with pytest.raises(ValueError):
        reg.histogram("serve_x_total")
    a = reg.counter("serve_y_total", labels={"reason": "a"})
    b = reg.counter("serve_y_total", labels={"reason": "b"})
    assert a is not b
    a.inc(2)
    b.inc(3)
    samples = validate_exposition(reg.render_prometheus())
    assert samples['serve_y_total{reason="a"}'] == 2
    assert samples['serve_y_total{reason="b"}'] == 3


def _fill(mod):
    """One registry of ``mod`` filled from a seeded script."""
    rng = np.random.default_rng(11)
    reg = mod.MetricsRegistry()
    reg.counter("serve_a_total", "a").inc(7)
    reg.gauge("serve_depth", "queue").set(3.5)
    for reason in ("queue_full", 'odd "quoted"\nreason'):
        reg.counter("serve_rej_total", "rejections",
                    labels={"reason": reason}).inc(int(rng.integers(1, 9)))
    h = reg.histogram("serve_lat_seconds", "lat")
    for v in rng.exponential(0.02, 200):
        h.observe(v)
    reg.histogram("serve_empty_seconds", "never observed")
    return reg


def test_exposition_text_matches_reference():
    text = _fill(ptel).render_prometheus()
    assert text == _fill(jtel).render_prometheus()
    samples = validate_exposition(text)
    assert parse_exposition(text) == samples
    assert samples == jtel.validate_exposition(text)


def test_exposition_round_trip_and_invariants():
    reg = MetricsRegistry()
    reg.counter("serve_a_total", "a").inc(7)
    reg.gauge("serve_depth", "queue").set(3.5)
    h = reg.histogram("serve_lat_seconds", "lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    samples = validate_exposition(text)
    assert parse_exposition(text) == samples
    assert samples["serve_a_total"] == 7
    assert samples["serve_depth"] == 3.5
    assert samples['serve_lat_seconds_bucket{le="+Inf"}'] == 4
    assert samples["serve_lat_seconds_count"] == 4
    assert samples["serve_lat_seconds_sum"] == pytest.approx(5.555)
    with pytest.raises(ValueError):
        validate_exposition("no_type_decl 1\n")
    with pytest.raises(ValueError):
        validate_exposition("# TYPE h histogram\n"
                            'h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
                            "h_count 3\n")


def test_metrics_server_scrape_and_404():
    reg = MetricsRegistry()
    reg.counter("serve_scrapeme_total").inc(11)
    srv = MetricsServer(reg, port=0).start()
    try:
        with urllib.request.urlopen(srv.url, timeout=10) as rsp:
            assert rsp.status == 200
            assert rsp.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            samples = validate_exposition(rsp.read().decode())
        assert samples["serve_scrapeme_total"] == 11
        base = srv.url.rsplit("/", 1)[0]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as rsp:
            assert rsp.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.stop()


def test_tracer_cap_and_chrome_export():
    """The cap, the JSONL and the Chrome export, each equal to the
    reference tracer's on the same events."""
    out = []
    for mod in (ptel, jtel):
        tr = mod.Tracer(clock=_tick_clock(), max_events=3)
        tr.event(0, "a")
        tr.span(1, "b", 1.0, 1.5, slot=0)
        tr.event(ENGINE_RID, "c")
        tr.event(0, "over")
        tr.event(0, "over2")
        out.append((len(tr), tr.dropped, tr.to_jsonl(), tr.to_chrome()))
    assert out[0] == out[1]
    n, dropped, jsonl, chrome = out[0]
    assert n == 3 and dropped == 2
    jl = [json.loads(line) for line in jsonl.splitlines()]
    assert [e["name"] for e in jl] == ["a", "b", "c"]
    ch = chrome["traceEvents"]
    assert [e["tid"] for e in ch] == [1, 2, 0]
    assert ch[1]["ph"] == "X" and ch[1]["dur"] == pytest.approx(0.5e6)
    assert ch[0]["ph"] == "i" and ch[0]["s"] == "t"
    tr = Tracer(clock=_tick_clock(), max_events=3)
    tr.event(0, "a")
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_heartbeat_injectable_clock():
    fake = [0.0]
    hb = Heartbeat(["w0", "w1"], timeout=5.0, clock=lambda: fake[0])
    assert hb.dead() == []
    fake[0] = 4.0
    hb.beat("w1")
    fake[0] = 6.0
    assert hb.dead() == ["w0"]
    assert hb.alive() == ["w1"]


def test_annotate_is_a_profiler_range_only_when_profiling():
    """A host span opens the profiler range of its name (``name#N``
    with a number) only with ``profile``, nested as the spans are;
    ``profile`` alone keeps spans and no lifecycle."""
    off = ServeTelemetry()
    assert off.spans is off.tracer and not off.spans.profile
    with off.spans.open("serve.decode_step", number=3) as sp:
        assert sp._range is None
    assert ServeTelemetry(trace=False).spans is None
    on = ServeTelemetry(trace=False, profile=True)
    assert on.tracer is None and on.spans.profile
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with on.spans.open("serve.decode_step", number=3):
            with on.spans.open("serve.decode.launch"):
                torch.ones(2).add_(1)
        with on.spans.open("serve.verify"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events() if e.name.startswith("serve.")]
    assert names == ["serve.decode_step#3", "serve.decode.launch",
                     "serve.verify"]
    assert [s["parent"] for s in on.spans.spans()] == [-1, 0, -1]


# --- the port's batcher ---------------------------------------------------------------


def test_trace_stitches_across_crash_recovery(model):
    """faults="step:2" under the supervisor: the supervisor's fault and
    restart events on ENGINE_RID, a recover_journal / recover_requeue
    per resubmitted request, and each rid's token events equal to the
    tokens its consumer drains (replayed pushes trace nothing)."""
    cfg, params = model
    pcfg = dataclasses.replace(cfg, kv_page_size=PAGE, prefill_chunk=PAGE)
    tel = ServeTelemetry()
    bat = _batcher(pcfg, params, n_slots=2, max_seq=64, queue_depth=64,
                   faults="step:2", telemetry=tel)
    sup = ServeSupervisor(bat, max_restarts=2)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, 12).astype(np.int32), max_new=6)
            for i in range(4)]
    for r in reqs:
        bat.submit(r)
    report = sup.run(len(reqs))
    assert report.restarts == 1
    outs = {r.rid: drain(r, timeout=10.0) for r in reqs}
    assert all(len(t) == 6 for t in outs.values())

    evs = tel.tracer.events()
    eng = [e for e in evs if e["rid"] == ENGINE_RID]
    faults = [e for e in eng if e["name"] == "supervisor_fault"]
    restarts = [e for e in eng if e["name"] == "supervisor_restart"]
    assert len(faults) == 1 and len(restarts) == 1
    assert "InjectedFault" in faults[0]["args"]["cause"]
    assert restarts[0]["args"]["restart"] == 1
    journaled = [e for e in evs if e["name"] == "recover_journal"]
    requeued = [e for e in evs if e["name"] == "recover_requeue"]
    assert len(journaled) >= 1
    assert len(journaled) + len(requeued) == report.recovered_requests
    for e in journaled:
        idx = evs.index(e)
        assert any(x["rid"] == e["rid"] for x in evs[:idx])
        assert any(x["rid"] == e["rid"] and x["name"] == "retire"
                   for x in evs[idx:])
    for r in reqs:
        n_tok = sum(1 for e in evs
                    if e["rid"] == r.rid and e["name"] == "token")
        assert n_tok == len(outs[r.rid]), f"rid {r.rid} double-traced"
    spans = [e for e in evs if e["name"] == "request"]
    assert sorted(e["rid"] for e in spans) == [0, 1, 2, 3]
    assert all(e["args"]["outcome"] == "retired" for e in spans)


def test_stats_alias_keys(model):
    cfg, params = model
    scfg = dataclasses.replace(
        cfg, kv_page_size=PAGE, prefill_chunk=PAGE,
        kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=0,
        speculate_k=4, speculate_ngram=1)
    tel = ServeTelemetry()
    bat = _batcher(scfg, params, n_slots=1, max_seq=48, queue_depth=8,
                   telemetry=tel)
    req = Request(rid=0, prompt=_motif_prompt(12), max_new=10)
    bat.submit(req)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    bat.step()
    bat._preempt(0)                        # one staged spill
    bat.run(1)
    assert len(drain(req)) == 10
    st = bat.stats()
    sp = st["speculation"]
    assert sp["drafted"] == sp["tokens_drafted"]
    assert sp["accepted"] == sp["tokens_accepted"]
    assert sp["rolled_back"] == sp["tokens_rolled_back"]
    assert sp["verify_steps"] == sp["verify_rounds"]
    tr = st["transfers"]
    assert tr["staged_gathers"] == tr["gathers"] >= 1
    assert tr["staged_scatters"] == tr["scatters"] >= 1
    assert tel.h_gather.count == tr["gathers"]
    assert tel.h_scatter.count == tr["scatters"]
    assert tel.h_gather.sum == tr["gather_seconds"]
    samples = validate_exposition(tel.render_prometheus())
    assert samples["serve_transfer_gathers_total"] == tr["gathers"]
    assert samples["serve_spec_verify_rounds_total"] == sp["verify_rounds"]
    assert samples["serve_steps_total"] == bat.steps


def test_transfer_engine_fake_clock_timing(model):
    """The staged engine's seconds come from the injected clock: each
    timed op brackets its work with two consecutive reads, so under the
    tick clock the totals are exactly gathers * dt and scatters * dt."""
    cfg, params = model
    tcfg = dataclasses.replace(
        cfg, kv_page_size=PAGE, prefill_chunk=PAGE,
        kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=0)
    bat = _batcher(tcfg, params, n_slots=1, max_seq=48, queue_depth=8,
                   clock=_tick_clock())
    assert bat._xfer._clock is bat._clock
    req = Request(rid=0, prompt=_motif_prompt(12), max_new=8)
    bat.submit(req)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    bat._preempt(0)
    bat.run(1)
    assert len(drain(req)) == 8
    tr = bat.stats()["transfers"]
    assert tr["gathers"] >= 1 and tr["scatters"] >= 1
    assert tr["gather_seconds"] == tr["gathers"] * TICK
    assert tr["scatter_seconds"] == tr["scatters"] * TICK


def _serve(cfg, params, prompts, max_new, telemetry, **kw):
    bat = _batcher(cfg, params, n_slots=2, max_seq=48, queue_depth=8,
                   telemetry=telemetry, **kw)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=60)
    assert not prod.is_alive()
    return [drain(r, timeout=10.0) for r in reqs], bat


OFF_ON_CASES = {
    "paged prefix + spec": dict(kv_page_size=PAGE, prefill_chunk=PAGE,
                                prefix_cache=True, speculate_k=4,
                                speculate_ngram=1),
    "dense": dict(decode_flash=True),
    "int8 pages, preempting": dict(kv_page_size=PAGE, prefill_chunk=PAGE,
                                   kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("case", list(OFF_ON_CASES))
def test_telemetry_off_and_on_bit_identical(model, case):
    """Instrumentation never perturbs decode: a batcher with telemetry
    (tracing, host spans and profiler ranges on) streams the tokens of
    one without, and its spans count its steps and chunks."""
    cfg, params = model
    c = dataclasses.replace(cfg, **OFF_ON_CASES[case])
    rng = np.random.default_rng(7)
    prompts = [_motif_prompt(11),
               rng.integers(0, cfg.vocab_size, 9).astype(np.int32),
               _motif_prompt(14)]
    kw = {"n_pages": 4} if "preempting" in case else {}
    off, bat_off = _serve(c, params, prompts, 8, None, **kw)
    tel = ServeTelemetry(profile=True)
    on, bat_on = _serve(c, params, prompts, 8, tel, **kw)
    assert on == off
    assert bat_off._telemetry is None
    assert "latency" not in bat_off.stats()
    lat = bat_on.stats()["latency"]
    assert lat["ttft"]["count"] == len(prompts)
    assert lat["decode_step"]["count"] + lat["verify_round"]["count"] \
        == bat_on.steps == bat_off.steps
    if "preempting" in case:
        assert bat_on.preemptions == bat_off.preemptions >= 1
        assert lat["spill"]["count"] == bat_on.preemptions
    if "spec" in case:
        assert bat_on.spec_drafted == bat_off.spec_drafted
    names = [sp["name"] for sp in tel.spans.spans()]
    assert names.count("serve.decode_step") == \
        names.count("serve.decode.wait") == bat_on.steps
    assert names.count("serve.verify") == bat_on.spec_verify_steps
    assert names.count("serve.prefill_chunk") == bat_on.prefill_chunks
    assert names.count("serve.iteration") == names.count("serve.admit") > 0


def test_profile_ranges_count_the_steps(model):
    """Under an active profiler every serving step sits in its range:
    ``serve.decode_step#N`` once per ``step()`` (N its step number),
    holding ``serve.verify`` on a verify round and
    ``serve.decode.launch`` on a plain one, ``serve.decode.wait`` on
    both; ``serve.prefill_chunk#N`` per chunk; an ``serve.admit`` range
    in every ``serve.iteration``."""
    cfg, params = model
    c = dataclasses.replace(cfg, **OFF_ON_CASES["paged prefix + spec"])
    prompts = [_motif_prompt(11), _motif_prompt(13)]
    tel = ServeTelemetry(profile=True)
    bat = _batcher(c, params, n_slots=2, max_seq=48, queue_depth=8,
                   telemetry=tel)
    plain = _serve(dataclasses.replace(c, speculate_k=0), params, prompts,
                   10, None)[0]
    _oracle_drafts(bat, plain)
    oracle = bat._draft                    # every other step plain decode
    bat._draft = lambda slot: oracle(slot) if bat.steps % 2 == 0 else []
    reqs = [Request(rid=i, prompt=p, max_new=10)
            for i, p in enumerate(prompts)]
    for r in reqs:
        bat.submit(r)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        bat.run(len(reqs))
    assert [drain(r) for r in reqs] == plain
    names = [e.name for e in prof.events() if e.name.startswith("serve.")]
    decode = [n for n in names if n.startswith("serve.decode_step#")]
    assert len(decode) == bat.steps >= 1
    assert names.count("serve.verify") == bat.spec_verify_steps >= 1
    assert names.count("serve.decode.launch") == \
        bat.steps - bat.spec_verify_steps >= 1
    assert names.count("serve.decode.wait") == bat.steps
    assert names.count("serve.admit") == names.count("serve.iteration") \
        >= len(decode) + bat.prefill_chunks
    assert sum(n.startswith("serve.prefill_chunk#") for n in names) \
        == bat.prefill_chunks
    steps = sorted(int(n.split("#")[1]) for n in decode)
    assert len(set(steps)) == len(steps) and steps[-1] < bat.steps


# --- the lifecycle twin ---------------------------------------------------------------


def _oracle_drafts(bat, plain):
    """Draft the plain run's own continuation, so verify rounds commit
    tokens (the smoke model's greedy text rarely repeats itself, which
    leaves the n-gram drafter idle)."""
    def draft(slot):
        r = bat._slot_req[slot]
        done = bat._host_pos[slot] - len(r.prompt) + 1
        cap = min(bat.speculate_k, bat._host_remaining[slot] - 1)
        return list(plain[r.rid][done:done + cap]) if cap > 0 else []
    bat._draft = draft


def _lifecycle_cfg(cfg, speculate_k=4):
    return dataclasses.replace(
        cfg, kv_page_size=PAGE, prefill_chunk=PAGE, prefix_cache=True,
        kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=0,
        speculate_k=speculate_k, speculate_ngram=1)


def test_full_lifecycle_trace_reconstruction(model):
    """One request prefix-hits, speculates, is preempted through the
    staged spill and restored; its TTFT, chunk times, inter-token gaps
    and acceptance rebuilt from the JSONL alone equal the histograms and
    the batcher's counters exactly, and its token events are the tokens
    its consumer drained."""
    cfg, params = model
    prompt = _motif_prompt(16)
    plain = _serve(_lifecycle_cfg(cfg, speculate_k=0), params,
                   [prompt, prompt], 12, None)[0]
    clk = _tick_clock()
    tel = ServeTelemetry(clock=clk)
    bat = _batcher(_lifecycle_cfg(cfg), params, n_slots=2, max_seq=64,
                   queue_depth=8, telemetry=tel)
    assert bat._clock is clk and tel.tracer.clock is clk
    _oracle_drafts(bat, plain)

    warm = Request(rid=0, prompt=prompt, max_new=4)
    bat.submit(warm)
    bat.run(1)
    toks0 = drain(warm)
    assert toks0 == plain[0][:4]
    req = Request(rid=1, prompt=prompt, max_new=12)
    bat.submit(req)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    bat.step()                             # one verify round
    slot = next(i for i, r in enumerate(bat._slot_req)
                if r is not None and r.rid == 1)
    bat._preempt(slot)
    bat.run(2)
    toks1 = drain(req)
    assert toks1 == plain[1]
    st = bat.stats()
    assert bat.preemptions == bat.resumes == 1
    assert st["prefix_hits"] == 1
    assert st["speculation"]["tokens_accepted"] > 0

    evs = [json.loads(line) for line in tel.tracer.to_jsonl().splitlines()]
    assert len(evs) == len(tel.tracer) and tel.tracer.dropped == 0
    by_rid = {}
    for e in evs:
        by_rid.setdefault(e["rid"], {}).setdefault(e["name"], []).append(e)
    r1 = [e for e in evs if e["rid"] == 1]
    names = [e["name"] for e in r1]
    by = by_rid[1]
    for needed in ("submit", "admit", "prefill_chunk", "first_token",
                   "token", "spec_verify", "preempt", "spill", "restore",
                   "resume", "retire", "request"):
        assert needed in names, f"rid 1 trace missing {needed!r}"
    order = [names.index(n) for n in ("submit", "admit", "first_token",
                                      "preempt", "resume", "retire")]
    assert order == sorted(order)
    assert by["spill"][0]["ts"] < by["preempt"][0]["ts"]
    admit = by["admit"][0]["args"]
    assert admit["prefix_hit_tokens"] == 16 and admit["resume"] is False
    assert 0 < admit["start"] <= admit["prefix_hit_tokens"]
    assert admit["queue_s"] > 0
    assert by["preempt"][0]["args"]["mode"] == "spill"
    assert by["resume"][0]["args"]["mode"] == "restore"

    # TTFT: first_token.ts - submit.ts, per request, and their sum is
    # the histogram's.
    ttft = {rid: b["first_token"][0]["ts"] - b["submit"][0]["ts"]
            for rid, b in by_rid.items() if rid != ENGINE_RID}
    assert ttft[1] == by["first_token"][0]["args"]["ttft_s"] > 0
    assert tel.h_ttft.count == 2 and tel.h_ttft.sum == ttft[0] + ttft[1]

    # chunk times: the spans' durations are the histogram's samples.
    chunks = [e for e in evs if e["name"] == "prefill_chunk"]
    assert len(chunks) == tel.h_chunk.count == bat.prefill_chunks
    assert tel.h_chunk.sum == sum(c["dur"] for c in chunks)
    assert all(c["dur"] > 0 for c in chunks)
    c1 = by["prefill_chunk"]
    assert [c["args"]["chunk"] for c in c1] == list(range(len(c1)))
    assert len(c1) == admit["n_chunks"] and c1[-1]["args"]["final"] is True

    # inter-token gaps: one token event per drained token, gaps between
    # consecutive stamps, summed over both requests.
    gaps = []
    for rid, toks in ((0, toks0), (1, toks1)):
        stamps = [e["ts"] for e in by_rid[rid]["token"]]
        assert len(stamps) == len(toks) and stamps == sorted(stamps)
        pos = [e["args"]["pos"] for e in by_rid[rid]["token"]]
        assert pos == sorted(pos) and pos[0] == len(prompt)
        gaps += [b - a for a, b in zip(stamps, stamps[1:])]
    assert tel.h_gap.count == len(gaps)
    assert tel.h_gap.sum == sum(gaps)

    # speculation: the spec_verify events sum to the batcher's counters.
    spec = [e["args"] for e in evs if e["name"] == "spec_verify"]
    assert sum(a["drafted"] for a in spec) == st["speculation"][
        "tokens_drafted"] > 0
    assert sum(a["accepted"] for a in spec) == st["speculation"][
        "tokens_accepted"]
    assert all(a["rolled_back"] == a["drafted"] - a["accepted"]
               for a in spec)

    # spill / restore, and the engine's decode and verify spans.
    assert tel.h_spill.count == tel.h_restore.count == 1
    assert tel.h_spill.sum == by["spill"][0]["dur"]
    assert tel.h_restore.sum == by["restore"][0]["dur"]
    eng = by_rid[ENGINE_RID]
    assert tel.h_step.count == len(eng.get("decode_step", []))
    assert tel.h_step.sum == sum(e["dur"] for e in eng.get("decode_step",
                                                            []))
    assert tel.h_verify.count == len(eng["verify_round"]) == st[
        "speculation"]["verify_rounds"] >= 1
    assert tel.h_step.count + tel.h_verify.count == bat.steps

    span = by["request"][0]
    assert span["args"]["outcome"] == "retired"
    assert span["ts"] == by["submit"][0]["ts"]
    assert span["ts"] + span["dur"] == by["retire"][0]["ts"]

    samples = validate_exposition(tel.render_prometheus())
    assert samples["serve_requests_submitted_total"] == 2
    assert samples["serve_retired_total"] == 2
    assert samples["serve_preemptions_total"] == 1
    assert samples["serve_prefix_hits_total"] == 1
    assert samples["serve_ttft_seconds_count"] == 2
    assert samples["serve_spec_tokens_drafted_total"] == st["speculation"][
        "tokens_drafted"]
    ch = tel.tracer.to_chrome()["traceEvents"]
    assert len(ch) == len(evs) and {e["tid"] for e in ch} == {0, 1, 2}
    for alloc in bat._alloc.values():
        alloc.check_consistency()
