"""A run of a cell driven on the CPU at smoke width, past the harness's
look for a chip, with the timed path broken underneath: ``correct``
must come out false for each fault a serving cell can have, and for the
fp8 control put in the program's place, and true without either.  The
faults: a token altered where it is produced (the decode step's greedy
pick), and a step that returns its state unchanged (positions not
advanced, so every step rewrites one cache row)."""

import json
import time

import pytest
import torch

from bench import runner
from bench.smoke import smoke_cell


@pytest.fixture(autouse=True)
def other_tests_modules(monkeypatch):
    """A test worker holds the JAX package that other test files load;
    the benchmark's own process never does (``test_bench_imports.py``
    checks that in a fresh interpreter), so the run's look for it is
    left out here."""
    from bench import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


CELLS = ["minitron-4b.decode-heavy"]


def run(name, monkeypatch, fault=None):
    import repro_torch.serve.serve_loop as SL
    cell, cfg = smoke_cell(name)
    if fault is not None:
        inner = SL.advance_slots

        def broken(logits, last_tok, pos, remaining, active, max_seq):
            out = inner(logits, last_tok, pos, remaining, active, max_seq)
            nxt, npos, rem, act, rows = out
            if fault == "token":
                rows = rows.clone()
                rows[0] = (rows[0] + 1) % cfg.padded_vocab
                nxt = rows[0]
            else:
                npos = pos
            return nxt, npos, rem, act, rows
        monkeypatch.setattr(SL, "advance_slots", broken)
    line = runner.run_cell(cell, 2 ** 31 + 77, 1.0, False,
                           torch.device("cpu"), time.perf_counter(), cfg=cfg)
    return json.loads(line)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    out = run(name, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    out = run(name, monkeypatch, fault)
    assert not out["correct"], out["checks"]



# The fp8 control at smoke width lies closer to the reference than at
# full width (gap 0.14-0.43, mismatch_share 0.10-0.28 over three seeds,
# against the program's 0.006-0.035 and 0.006-0.059), so here it is held
# to limits set between those two readings, as the cell's own are set
# between its full-width ones.  The run is in float32, whose CPU steps
# keep their pace from the first run, and its window outlasts every
# request, so the judged sample does not hang on timing.
SMOKE_LIMITS = {"gap": 0.08, "mismatch_share": 0.08}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, monkeypatch):
    """The fp8 control judged in the program's place, at the positions
    the program served: its numbers are the ones checked, and they fail
    the limits that the program's readings of the same run keep."""
    from bench import serve
    monkeypatch.setattr(runner, "limits", lambda cell: dict(SMOKE_LIMITS))
    seen = {}

    def judge(*a, **kw):
        seen.update(real(*a, **kw))
        return seen
    real = serve.judge
    monkeypatch.setattr(serve, "judge", judge)
    cell, cfg = smoke_cell(name, dtype="float32")
    out = json.loads(runner.run_cell(
        cell, 2 ** 31 + 77, 8.0, False, torch.device("cpu"),
        time.perf_counter(), cfg=cfg, lowp="fp8"))
    assert seen["control"]["requests"] == 6, seen
    assert not out["correct"], out["checks"]
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        k: seen["control"][k] for k in SMOKE_LIMITS}
    assert all(seen["program"][k] <= v for k, v in SMOKE_LIMITS.items()), \
        seen
