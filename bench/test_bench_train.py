"""The training cell driven on the CPU at smoke width, past the look
for a chip: sound, it is correct; the control and a planted fault put
in the program's place are not; with the timed path broken underneath
(the update returning the state unchanged; half the batch left out,
the mean taken over the rest) the numbers they break come out past the
cell's limits."""

import dataclasses
import json
import time

import pytest
import torch

from bench import harness, runner


@pytest.fixture(autouse=True)
def other_tests_modules(monkeypatch):
    """A test worker holds the JAX package that other test files load;
    the benchmark's own process never does (``test_bench_imports.py``
    checks that in a fresh interpreter), so the run's look for it is
    left out here."""
    from bench import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


NAME = "minitron-4b.train-1k"


def smoke():
    from repro_torch import configs
    from repro_torch.configs.base import smoke_variant
    cell = harness.resolve(NAME)
    cfg = dataclasses.replace(smoke_variant(configs.get("minitron-4b")),
                              dtype="bfloat16")
    cell.config = harness.file_view(cfg)
    cell.traffic["params"].update(batch=2, seq=64)
    return cell, cfg


def run(monkeypatch, fault=None, lowp=None):
    import repro_torch.train.optimizer as OPT
    import repro_torch.train.train_loop as TL
    cell, cfg = smoke()
    if fault == "state":
        inner = OPT.update

        def unchanged(c, grads, state, params):
            _, st, m = inner(c, grads, state, _copy(params))
            return params, st, m
        monkeypatch.setattr(OPT, "update", unchanged)
    elif fault == "half":
        inner = TL.loss_fn

        def half(c, params, batch):
            b = batch["tokens"].shape[0]
            return inner(c, params, {k: v[: b // 2] for k, v in
                                     batch.items()})
        monkeypatch.setattr(TL, "loss_fn", half)
    line = runner.run_cell(cell, 2 ** 31 + 5, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), cfg=cfg, lowp=lowp)
    return json.loads(line)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


def test_sound_steps_are_correct(monkeypatch):
    out = run(monkeypatch)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"grad_gap", "change_gap", "loss_gap"}
    assert list(out)[-1] == "checks"


def test_the_control_breaks_the_gradient_limit(monkeypatch):
    """The fp8 control judged in the program's place, against the cell's
    own limits, is not correct: its gradient lies past the limit."""
    out = run(monkeypatch, lowp="fp8")
    assert not out["correct"], out["checks"]
    g = out["checks"]["grad_gap"]
    assert g["value"] > g["limit"], out["checks"]


def test_the_planted_half_batch_is_not_correct(monkeypatch):
    """The reference with half the batch left out, in the program's
    place (``control.py --lowp half_batch``), is not correct."""
    out = run(monkeypatch, lowp="half_batch")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["state", "half"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    out = run(monkeypatch, fault)
    assert not out["correct"], out["checks"]
