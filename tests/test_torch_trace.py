"""The port's ``core/trace.Tracer``: host spans in the serving loop and
the train step, their parents and owners, the anchors that put them on
the profiler's clock, the per-step token runs against the per-token
events they stand for, and what tracing costs when it is off (no clock
read) and changes when it is on (nothing).  Port weights only
(``registry.init`` at smoke width); no JAX."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.core.trace import ENGINE_RID, Tracer, _TokenRun
from repro_torch.models import registry
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.telemetry import ServeTelemetry
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_loop as TL

torch.set_num_threads(2)

PAGE = 8
DECODE = ("serve.grow", "serve.decode.launch", "serve.decode.wait",
          "serve.decode.emit")


@pytest.fixture(scope="module")
def model():
    cfg = smoke_variant(configs.get("minitron-4b"))
    return cfg, registry.init(cfg, 0, device="cpu")


class Counting:
    """A fake clock that counts its reads; each read moves it on by a
    power of two, so every stamp and difference is exact."""

    def __init__(self, start=64.0, dt=2.0 ** -12):
        self.t, self.dt, self.reads = start, dt, 0

    def __call__(self):
        self.reads += 1
        self.t += self.dt
        return self.t


def _paged(cfg, **kw):
    return dataclasses.replace(cfg, kv_page_size=PAGE, prefill_chunk=PAGE,
                               **kw)


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, 9 + 2 * i).astype(np.int32)
            for i in range(n)]


def _admitted(cfg, params, clock, telemetry=None, max_new=12):
    """A paged batcher whose requests are all admitted and prefilled:
    the next ``step()`` calls are plain decode steps."""
    bat = ContinuousBatcher(_paged(cfg), params, n_slots=2, max_seq=48,
                            queue_depth=8, clock=clock, telemetry=telemetry,
                            device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(cfg, 2))]
    for r in reqs:
        bat.submit(r)
    bat.admit()
    while bat._admitting:
        bat._prefill_step()
    return bat, reqs


def _serve(cfg, params, telemetry, n=3, max_new=6):
    bat = ContinuousBatcher(cfg, params, n_slots=2, max_seq=48,
                            queue_depth=8, telemetry=telemetry, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(cfg, n))]
    for r in reqs:
        bat.submit(r)
    bat.run(len(reqs))
    return [drain(r, timeout=10.0) for r in reqs], bat


# --- off costs no clock read; on, one pair feeds span and rate ---------------------


def test_off_reads_no_clock_per_decode_step(model, monkeypatch):
    """Telemetry off: a decode step reads the batcher's clock 0 times.
    On: once per span boundary (the wait and the emit start where the
    span before ended), and wall time not at all, since the launch's
    pair feeds the rate model too."""
    cfg, params = model
    clk = Counting()
    bat, _ = _admitted(cfg, params, clk)
    before = clk.reads
    for _ in range(3):
        bat.step()
    assert clk.reads == before and bat._tracer is None

    clk = Counting()
    bat, _ = _admitted(cfg, params, clk, telemetry=ServeTelemetry())
    walls = []
    monkeypatch.setattr(time, "monotonic",
                        lambda: walls.append(1) or 0.0)
    before = clk.reads
    bat.step()
    # decode_step 2, grow 2, launch 2, wait 1, emit 1
    assert clk.reads - before == 8 and walls == []
    launch = [s for s in bat._tracer.spans()
              if s["name"] == "serve.decode.launch"][-1]
    assert bat._ewma_step_s == launch["t1"] - launch["t0"]


def test_off_reads_no_clock_per_train_step(model, monkeypatch):
    """No tracer: a train step reads no clock at all (every ``time``
    reader counted).  A tracer: one read per span boundary, the
    backward starting where the forward ended."""
    cfg, _ = model
    reads = []
    for name in ("monotonic", "perf_counter", "time", "time_ns"):
        real = getattr(time, name)
        monkeypatch.setattr(time, name,
                            lambda real=real: reads.append(1) or real())
    params = registry.init(cfg, 0, device="cpu")
    opt_state = OPT.init(params)
    batch = _train_batch(cfg, 0)
    step = TL.make_train_step(cfg, TL.TrainCfg())
    del reads[:]
    step(params, opt_state, batch)
    assert reads == []
    clk = Counting()
    tr = Tracer(clk)
    tr.anchor()
    step = TL.make_train_step(cfg, TL.TrainCfg(), tracer=tr)
    before = clk.reads
    step(params, opt_state, batch)
    assert clk.reads - before == 7


# --- spans nest, with parents and owners ----------------------------------------------


def test_serving_spans_nest_under_their_parents(model):
    """Every span's parent is the one the loop's structure gives: admit,
    prefill chunks and decode steps under an iteration; grow, launch,
    wait and emit under a decode step, owned by its step number; a
    chunk owned by its request.  Children tile their decode step in
    order, and each step's wait ends where its tokens are stamped."""
    cfg, params = model
    tel = ServeTelemetry(clock=Counting())
    toks, bat = _serve(_paged(cfg), params, tel)
    spans = tel.tracer.spans()
    by_id = {s["id"]: s for s in spans}
    want = {"serve.iteration": None, "serve.admit": "serve.iteration",
            "serve.prefill_chunk": "serve.iteration",
            "serve.decode_step": "serve.iteration"}
    want.update({n: "serve.decode_step" for n in DECODE})
    assert {s["name"] for s in spans} == set(want)
    for s in spans:
        parent = by_id[s["parent"]]["name"] if s["parent"] >= 0 else None
        assert parent == want[s["name"]], s
        assert s["t0"] <= s["t1"]
        if parent is not None:
            p = by_id[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
    steps = [s for s in spans if s["name"] == "serve.decode_step"]
    assert [s["owner"] for s in steps] == list(range(bat.steps))
    assert all(s["args"]["n_live"] >= 1 for s in steps)
    for st in steps:
        kids = [s for s in spans if s["parent"] == st["id"]]
        assert [k["name"] for k in kids] == list(DECODE)
        assert all(k["owner"] == st["owner"] for k in kids)
        for a, b in zip(kids[1:], kids[2:]):
            assert a["t1"] == b["t0"]        # launch | wait | emit
    chunks = [s for s in spans if s["name"] == "serve.prefill_chunk"]
    assert len(chunks) == bat.prefill_chunks
    assert sorted({c["owner"] for c in chunks}) == [0, 1, 2]
    waits = {s["t1"] for s in spans if s["name"] == "serve.decode.wait"}
    stamps = {e["ts"] for e in tel.tracer.events() if e["name"] == "token"}
    firsts = {e["ts"] for e in tel.tracer.events()
              if e["name"] == "first_token"}
    assert stamps - firsts == waits


def test_open_close_parents_and_the_cap():
    """A span's parent is the span open when it began; closing an outer
    span closes what is still open inside it; past the cap spans are
    timed, not kept, and counted as dropped."""
    tr = Tracer(Counting(), max_events=5)
    a = tr.open("a", owner=7)
    b = tr.open("b")
    c = tr.open("c", owner=9)
    t = a.close()
    assert b.t1 == c.t1 == t == a.t1
    d = tr.open("d", at=t)
    tr.event(0, "x")
    e = tr.open("e")
    assert d.t0 == t and e.id == -1 and tr.dropped == 1
    e.close()
    d.close(n=3)
    got = [(s["name"], s["parent"], s["owner"], s["args"])
           for s in tr.spans()]
    assert got == [("a", -1, 7, {}), ("b", 0, 7, {}), ("c", 1, 9, {}),
                   ("d", -1, None, {"n": 3})]
    assert len(tr) == 5
    tr.clear()
    assert len(tr) == 0 and tr.spans() == [] and tr.dropped == 0


# --- the profiler's clock ----------------------------------------------------------------


def test_anchor_interpolation_is_exact():
    """Between the two anchors nearest a stamp, linear in both
    directions; past the ends, the nearest pair extended; one anchor,
    an offset."""
    tr = Tracer(Counting())
    tr._anchors = [(0.0, 1_000_000_000), (2.0, 3_000_000_000),
                   (4.0, 7_000_000_000)]
    assert tr.to_unix_ns(0.5) == 1_500_000_000
    assert tr.to_unix_ns(3.0) == 5_000_000_000     # the pair (2, 4)
    assert tr.to_unix_ns(5.0) == 9_000_000_000
    assert tr.to_unix_ns(-1.0) == 0
    for t in (0.5, 1.25, 3.0, 3.75, 5.0):
        assert tr.from_unix_ns(tr.to_unix_ns(t)) == t
    tr._anchors = [(2.0, 3_000_000_000)]
    assert tr.to_unix_ns(2.5) == 3_500_000_000
    assert tr.from_unix_ns(2_500_000_000) == 1.5


def test_anchors_on_a_clock_and_after_a_new_one():
    """The first span takes an anchor (one clock read between two
    ``time_ns`` reads); ``spans(unix=True)`` lies near ``time_ns``; a
    new clock forgets the old clock's anchors."""
    tr = Tracer(time.perf_counter)
    a = time.time_ns()
    with tr.open("x"):
        pass
    b = time.time_ns()
    (s,) = tr.spans(unix=True)
    assert a - 1e6 <= s["t0"] <= s["t1"] <= b + 1e6
    assert len(tr._anchors) == 1
    tr.anchor()
    assert len(tr._anchors) == 2
    tr.bind(time.monotonic)
    assert tr._anchors == []


# --- token runs export to the per-token events ------------------------------------------


def test_token_runs_export_the_per_token_events():
    """Tokens recorded as runs (one per stamp until another event
    comes) export the JSONL and Chrome events that one dict per token
    gave, in order, and count as many against the cap."""
    seq = [("tok", 0, 0, 5, 1.0), ("tok", 1, 1, 7, 1.0),
           ("ev", 1, "retire", 1.0), ("tok", 2, 0, 9, 1.0),
           ("tok", 0, 0, 6, 2.0), ("tok", 2, 1, 10, 2.0)]
    runs, dicts = Tracer(Counting()), Tracer(Counting())
    for x in seq:
        if x[0] == "tok":
            _, rid, slot, pos, ts = x
            runs.token(rid, slot, pos, ts)
            dicts.event(rid, "token", ts=ts, slot=slot, pos=pos)
        else:
            for tr in (runs, dicts):
                tr.event(x[1], x[2], ts=x[3], slot=1)
    assert len(runs._events) == 4 and len(dicts._events) == 6
    assert runs.events() == dicts.events()
    assert runs.to_jsonl() == dicts.to_jsonl()
    assert runs.to_chrome() == dicts.to_chrome()
    assert len(runs) == len(dicts) == 6
    capped = Tracer(Counting(), max_events=2)
    for rid in range(4):
        capped.token(rid, rid, 3, 1.0)
    assert len(capped) == 2 and capped.dropped == 2
    assert [e["rid"] for e in capped.events()] == [0, 1]


def test_a_decode_step_is_one_token_record(model):
    """Through the batcher a step's tokens are one run each (split only
    where a slot retires between them); the JSONL holds a token event
    per drained token and the spans after the lifecycle."""
    cfg, params = model
    tel = ServeTelemetry(clock=Counting())
    toks, bat = _serve(_paged(cfg), params, tel, n=2, max_new=7)
    runs = [e for e in tel.tracer._events if isinstance(e, _TokenRun)]
    multi = [r for r in runs if len(r.rids) > 1]
    assert multi and len(runs) <= bat.steps + 2 * bat.retired
    jl = [json.loads(line) for line in tel.tracer.to_jsonl().splitlines()]
    assert sum(e["name"] == "token" for e in jl) == sum(map(len, toks))
    n_ev = len(tel.tracer.events())
    assert all(e["rid"] == ENGINE_RID and e["name"].startswith("serve.")
               and "span" in e["args"] for e in jl[n_ev:])
    assert len(jl) == len(tel.tracer)
    ch = tel.tracer.to_chrome()["traceEvents"]
    assert {e["pid"] for e in ch[n_ev:]} == {1}


# --- tracing changes no result ------------------------------------------------------------


def _train_batch(cfg, k):
    g = torch.Generator().manual_seed(100 + k)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def test_train_step_under_a_tracer_is_bit_identical(model):
    """Two steps with and without a tracer: equal losses and parameters
    bit for bit; each step a ``train.step`` holding ``train.forward``,
    ``train.backward`` and ``train.optimizer`` in that order, owned by
    its ordinal; with ``grad_accum`` 2, a forward and a backward per
    microbatch."""
    cfg, _ = model
    for accum in (1, 2):
        tcfg = TL.TrainCfg(grad_accum=accum)
        out = []
        for tr in (None, Tracer(Counting())):
            params = registry.init(cfg, 0, device="cpu")
            opt_state = OPT.init(params)
            step = TL.make_train_step(cfg, tcfg, tracer=tr)
            losses = []
            for k in range(2):
                params, opt_state, m = step(params, opt_state,
                                            _train_batch(cfg, k))
                losses.append(m["loss"].item())
            out.append((losses, params, tr))
        (l0, p0, _), (l1, p1, tr) = out
        assert l0 == l1
        for a, b in zip(_leaves(p0), _leaves(p1)):
            assert torch.equal(a, b)
        spans = tr.spans()
        by_id = {s["id"]: s for s in spans}
        top = [s for s in spans if s["parent"] == -1]
        assert [s["name"] for s in top] == ["train.step"] * 2
        assert [s["owner"] for s in top] == [0, 1]
        for st in top:
            kids = [s["name"] for s in spans if s["parent"] == st["id"]]
            assert kids == ["train.forward", "train.backward"] * accum \
                + ["train.optimizer"]
        assert all(by_id[s["parent"]]["owner"] == s["owner"]
                   for s in spans if s["parent"] >= 0)


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out
