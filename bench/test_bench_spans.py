"""The readings of the program's host spans beside the card's kernels
(``metrics/host_spans.py``) on synthetic spans and kernel intervals,
where every number is worked out by hand; and the traced runs of
``scripts/trace_cells.py`` driven on the CPU at smoke width: the
program's tracing on changes no served token and no train step, and
its host-span readings read something."""

import importlib.util
import time
from pathlib import Path

import pytest
import torch

from bench.metrics import host_spans as H

MS = 1e-3
ROOT = Path(__file__).resolve().parents[1]


def span(i, name, t0, t1, parent=-1):
    return {"id": i, "parent": parent, "owner": None, "name": name,
            "t0": t0 * MS, "t1": t1 * MS, "args": {}}


# (id, parent, name, t0, t1) in ms
SERVING = [
    (0, -1, "serve.iteration", 0.0, 40.0),
    (1, 0, "serve.admit", 0.0, 0.2),
    (2, 0, "serve.decode_step", 0.2, 40.0),
    (3, 2, "serve.grow", 0.2, 0.5),
    (4, 2, "serve.decode.launch", 0.5, 20.0),
    (5, 2, "serve.decode.wait", 20.0, 39.0),
    (6, 2, "serve.decode.emit", 39.0, 40.0),
    (7, -1, "serve.iteration", 40.05, 80.0),
    (8, 7, "serve.admit", 40.05, 40.25),
    (9, 7, "serve.decode_step", 40.25, 80.0),
    (10, 9, "serve.grow", 40.25, 40.5),
    (11, 9, "serve.decode.launch", 40.5, 60.0),
    (12, 9, "serve.decode.wait", 60.0, 79.0),
    (13, 9, "serve.decode.emit", 79.0, 80.0),
    (14, -1, "serve.iteration", 80.05, 100.0),
    (15, 14, "serve.admit", 80.05, 80.25),
    (16, 14, "serve.prefill_chunk", 80.25, 100.0)]
KERNELS = [("k1", 0.6, 5.0), ("k2", 10.0, 12.0), ("k3", 18.0, 38.9),
           ("k4", 40.6, 45.0), ("k5", 50.0, 52.0), ("k6", 58.0, 78.9),
           ("Memcpy DtoH (Device -> Pinned)", 60.0, 62.0),
           ("k7", 80.3, 99.9)]


def serving():
    """Two decode iterations and a prefill iteration: each decode
    step's kernels start just after its launch begins and end just
    before its wait does; 50 us between iterations in no span."""
    return {"spans": [span(i, n, a, b, p) for i, p, n, a, b in SERVING],
            "kernels": [(n, a * MS, b * MS) for n, a, b in KERNELS],
            "t0": 0.0, "t1": 0.1, "p0": 0.0, "p1": 0.1}


def test_idle_by_innermost_span():
    """Idle stretches [0, .6], [5, 10], [12, 18], [38.9, 40.6], [45, 50],
    [52, 58], [78.9, 80.3], [99.9, 100] ms, each put down to the span
    the host was innermost in (the copy overlaps a kernel: no gap)."""
    ctx = serving()
    by = H.idle_by_span(ctx, [(0.0, 0.1)])
    want = {"serve.admit": 0.6, "serve.grow": 0.55,
            "serve.decode.launch": 22.2, "serve.decode.wait": 0.2,
            "serve.decode.emit": 2.0, H.OUTSIDE: 0.1,
            "serve.prefill_chunk": 0.15}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v * MS), k
    assert sum(by.values()) == pytest.approx(25.8 * MS)


def test_kernels_per_step_and_the_idle_share():
    ctx = serving()
    assert H.kernels_per_decode_step(ctx) == 3.0     # the copy left out
    assert H.idle_in_launch_share(ctx) == pytest.approx(100 * 22.2 / 25.8)
    assert H.kernel_count(ctx["kernels"], 0.0, 0.1) == 7


def test_alignment_passes_aligned_and_fails_a_millisecond_off():
    """Aligned, every kernel lies in its launching spans; 1 ms later
    the first ms of each launch falls out, 1 ms earlier the last of each
    wait and of the chunk, both under 99.9%."""
    ctx = serving()
    assert H.serve_alignment(ctx) == pytest.approx(1.0)
    total = 4.4 + 2 + 20.9 + 4.4 + 2 + 20.9 + 2 + 19.6
    assert H.serve_alignment(ctx, +MS) == pytest.approx(
        (total - 0.4 - 0.45 - 0.75) / total)
    assert H.serve_alignment(ctx, -MS) == pytest.approx(
        (total - 0.9 * 3) / total)
    for d in (-MS, MS):
        assert H.serve_alignment(ctx, d) < 0.999
    assert H.serve_alignment(ctx, 0.0, H.SERVE_STEPS) == pytest.approx(1.0)
    # by count: every kernel inside its spans; 1 ms later k1, k4 and k7
    # start before theirs, 1 ms earlier k3, k6 and k7 end after theirs
    for d, want in ((0.0, 1.0), (MS, 5 / 8), (-MS, 5 / 8)):
        assert H.serve_alignment(ctx, d, share=H.contained_share) == want


def test_host_span_readers_leave_the_sub_window_out():
    """With the second decode iteration profiled, the host readers read
    the first alone; the prefill iteration is no decode iteration."""
    ctx = serving()
    ctx["p0"], ctx["p1"] = 40.05 * MS, 80.0 * MS
    assert H.mean_ms(ctx, "serve.decode_step") == pytest.approx(39.8)
    assert H.mean_ms(ctx, "serve.decode.launch") == pytest.approx(19.5)
    assert H.batcher_host_ms(ctx) == pytest.approx(0.2 + 0.3 + 1.0)
    assert H.kernels_per_decode_step(ctx) == 3.0


def test_readers_find_nothing_to_read():
    ctx = serving()
    ctx["kernels"] = []
    for f in (H.kernels_per_decode_step, H.idle_in_launch_share,
              H.serve_alignment):
        assert f(ctx) is None
    ctx = {"t0": 0.0, "t1": 1.0, "p0": None, "p1": None}
    assert H.mean_ms(ctx, "serve.decode_step") is None
    assert H.batcher_host_ms(ctx) is None


def training():
    """Four steps of 10 ms, 0.1 ms apart, the middle two profiled:
    ``train.step`` from 0.05 ms after the harness's start to 5.85 ms on,
    forward 2 ms, backward 2, optimizer 1.85; the card runs each
    profiled step's kernels to 0.1 ms before the harness's loss read
    ends."""
    spans, steps, kernels, i = [], [], [], 0
    for k in range(4):
        b = 10.0 * k + 0.1 * k
        t0 = b + 0.05
        spans += [span(i, "train.step", t0, t0 + 5.85),
                  span(i + 1, "train.forward", t0, t0 + 2, i),
                  span(i + 2, "train.backward", t0 + 2, t0 + 4, i),
                  span(i + 3, "train.optimizer", t0 + 4, t0 + 5.85, i)]
        i += 4
        prof = k in (1, 2)
        steps.append({"start": b * MS, "end": (b + 10.0) * MS,
                      "profiled": prof, "batch": 1, "seq": 8})
        if prof:
            kernels += [("f", t0 + 0.05, t0 + 1.85),
                        ("b", t0 + 2.35, t0 + 4.35),
                        ("o", t0 + 4.85, b + 9.9)]
    kernels = [(n, s * MS, e * MS) for n, s, e in kernels]
    return {"spans": spans, "kernels": kernels, "steps": steps,
            "p0": 10.1 * MS, "p1": 30.2 * MS}


def test_train_readers():
    """Per profiled step: idle 0.05 + 0.15 in the forward, 0.35 in the
    backward, 0.5 in the optimizer and 0.1 after the step returned."""
    ctx = training()
    assert H.median_ms(ctx, "train.backward") == pytest.approx(2.0)
    assert H.median_ms(ctx, "train.optimizer") == pytest.approx(1.85)
    assert H.kernels_per_train_step(ctx) == 3.0
    by = H.idle_by_span(ctx, H.step_intervals(ctx, profiled=True))
    assert by["train.forward"] == pytest.approx(2 * 0.2 * MS)
    assert by["train.backward"] == pytest.approx(2 * 0.35 * MS)
    assert by["train.optimizer"] == pytest.approx(2 * 0.5 * MS)
    assert by[H.OUTSIDE] == pytest.approx(2 * 0.1 * MS)
    assert H.idle_in_optimizer_share(ctx) == pytest.approx(
        100 * 0.5 / 1.15)
    assert H.train_alignment(ctx) == pytest.approx(1.0)
    assert H.train_alignment(ctx, MS) < 0.999


# --- the traced runs, on the CPU ----------------------------------------------------------


@pytest.fixture(autouse=True)
def other_tests_modules(monkeypatch):
    """A test worker holds the JAX package that other test files load;
    the benchmark's own process never does."""
    from bench import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def trace_cells():
    spec = importlib.util.spec_from_file_location(
        "trace_cells", ROOT / "scripts" / "trace_cells.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_traced_serving_run_serves_the_same_tokens():
    from bench import serve
    from bench.smoke import smoke_cell
    tc = trace_cells()
    cell, cfg = smoke_cell("minitron-4b.decode-heavy")
    cpu = torch.device("cpu")
    off = serve.run(cell, 2 ** 31 + 5, 1.0, False, cpu, cfg=cfg,
                    t_start=time.perf_counter())
    state = {}
    with tc.traced("serve", state, profiled=False):
        on = serve.run(cell, 2 ** 31 + 5, 1.0, True, cpu, cfg=cfg,
                       t_start=time.perf_counter())
    from repro_torch.serve import batching
    assert batching.ContinuousBatcher.__name__ == "ContinuousBatcher"
    a, b = off["finished"], on["finished"]
    both = set(a) & set(b)
    assert both
    for rid in both:
        n = min(len(a[rid].tok), len(b[rid].tok))
        assert a[rid].tok[:n] == b[rid].tok[:n]
    ctx = dict(on["ctx"], spans=state["tracer"].spans())
    assert H.mean_ms(ctx, "serve.decode_step") > 0
    assert H.mean_ms(ctx, "serve.decode.launch") > 0
    assert H.batcher_host_ms(ctx) > 0


def test_traced_train_run_steps_the_same():
    from bench import train
    from bench.test_bench_train import smoke
    tc = trace_cells()
    cell, cfg = smoke()
    cpu = torch.device("cpu")
    off = train.run(cell, 2 ** 31 + 9, 0.5, False, cpu, cfg=cfg,
                    t_start=time.perf_counter())
    state = {}
    with tc.traced("train", state, profiled=False):
        on = train.run(cell, 2 ** 31 + 9, 0.5, True, cpu, cfg=cfg,
                       t_start=time.perf_counter())
    assert on["losses"] == off["losses"]
    assert on["change"] == off["change"]
    ctx = dict(on["ctx"], spans=state["tracer"].spans())
    assert H.median_ms(ctx, "train.backward") > 0
    assert H.median_ms(ctx, "train.optimizer") > 0
