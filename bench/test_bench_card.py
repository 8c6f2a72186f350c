"""On the card: a serving cell at smoke width through the whole run on
CUDA (the kernels built, the traced sub-window read), correct, with a
device record.  Skips without a card; run on the chip with
``python -m pytest -q -m cuda bench/test_bench_card.py``."""

import json
import time

import pytest


@pytest.fixture(autouse=True)
def other_tests_modules(monkeypatch):
    """A test worker holds the JAX package that other test files load;
    the benchmark's own process never does (``test_bench_imports.py``
    checks that in a fresh interpreter), so the run's look for it is
    left out here."""
    from bench import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["minitron-4b.decode-heavy"])
def test_smoke_cell_on_the_card(card, name):
    from bench import runner
    from bench.smoke import smoke_cell
    cell, cfg = smoke_cell(name)
    line = runner.run_cell(cell, 2 ** 31 + 99, 2.0, True, card,
                           time.perf_counter(), cfg=cfg)
    out = json.loads(line)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert out["device"]["window_s"] >= out["device"]["busy_s"]
