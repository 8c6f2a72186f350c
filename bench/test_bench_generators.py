"""The traffic generators: a fixed schedule for a fixed seed, the same
set of sizes for every seed, and lengths inside their ranges."""

import numpy as np
import pytest
from bench.generators import backlog

BACKLOG = {"prompt_len": [256, 1024], "output_len": [512, 1536],
           "n_backlog": 64}

def sizes(reqs):
    return sorted((len(r["prompt"]), r["max_new"]) for r in reqs)


@pytest.mark.parametrize("gen,params,kw", [
    (backlog, BACKLOG, {"slots": 16}),
])
def test_fixed_for_a_seed(gen, params, kw):
    a = gen.generate(params, 2 ** 31 + 11, vocab=1000, **kw)
    b = gen.generate(params, 2 ** 31 + 11, vocab=1000, **kw)
    assert [(r["rid"], r["due_s"], r["max_new"]) for r in a] == \
        [(r["rid"], r["due_s"], r["max_new"]) for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))
    c = gen.generate(params, 5, vocab=1000, **kw)
    assert [r["max_new"] for r in a] != [r["max_new"] for r in c]
    # the same sizes and gaps between arrivals, in another order
    assert sorted(r["max_new"] for r in a if not r["initial"]) == sorted(
        r["max_new"] for r in c if not r["initial"])
    def gaps(rs):
        return np.sort(np.diff([0.0] + [r["due_s"] for r in rs]))
    assert gaps(a) == pytest.approx(gaps(c), abs=1e-9)


def test_backlog_lengths_and_steady_state():
    slots, max_seq = 128, 2560
    reqs = backlog.generate(BACKLOG, 7, vocab=1000, slots=slots)
    init = [r for r in reqs if r["initial"]]
    rest = [r for r in reqs if not r["initial"]]
    assert len(init) == slots and len(rest) == BACKLOG["n_backlog"]
    for r in init:
        # prompt plus "age", then what is left: within max_seq, at least
        # 2 new tokens (the batcher's floor)
        assert r["max_new"] >= 2
        assert len(r["prompt"]) + r["max_new"] <= max_seq
        assert len(r["prompt"]) < max_seq - 1
    assert all(256 <= len(r["prompt"]) <= 1024 for r in rest)
    assert all(512 <= r["max_new"] <= 1536 for r in rest)
    # in flight, contexts spread over the whole range
    ctx = [len(r["prompt"]) for r in init]
    assert min(ctx) < 600 and max(ctx) > 2000
    # the same sizes for every seed (the work does not move with it)
    other = backlog.generate(BACKLOG, 8, vocab=1000, slots=slots)
    assert sorted(r["max_new"] for r in rest) == sorted(
        r["max_new"] for r in other if not r["initial"])
    assert all(r["due_s"] == 0.0 for r in reqs)
