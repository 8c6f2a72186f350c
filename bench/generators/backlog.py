"""Offline backlog: a queue longer than any window drains, with the
slots already full and staggered when the window opens.

The slots start in the steady state of a full batch whose requests end
and are replaced: a request in flight has a length drawn with weight
proportional to its length and an age uniform over it (a renewal
process seen at a random time).  Each starts as a request whose prompt
is its own prompt plus ``age`` tokens already "generated" (random ids)
and whose budget is what is left; its prefill is the ramp, counted in
set-up.  The backlog behind them has the stated prompt and output
lengths.  Every request is due at once (``due_s`` 0)."""

from __future__ import annotations

import numpy as np

from . import grid, rng_of, tokens, uniform_ints


def generate(params, seed: int, *, vocab: int, slots: int, **_):
    p_lo, p_hi = params["prompt_len"]
    o_lo, o_hi = params["output_len"]
    rng = rng_of(seed, 1)
    reqs = []
    # in flight: length-biased output length, uniform age, the pairs
    # fixed (a golden-ratio sequence of age fractions against the length
    # quantiles) and dealt to the slots in an order from the seed, so
    # every seed starts from the same contexts and budgets.
    u = grid(slots)
    L = np.round(np.sqrt(o_lo ** 2 + u * (o_hi ** 2 - o_lo ** 2))
                 ).astype(np.int64)
    frac = np.modf((np.arange(slots) + 0.5) * 0.6180339887498949)[0]
    age = np.minimum(np.floor(frac * L), L - 2).astype(np.int64)
    P = np.floor(p_lo + np.modf((np.arange(slots) + 0.5) * 0.7548776662466927
                                )[0] * (p_hi - p_lo + 1)).astype(np.int64)
    order = rng.permutation(slots)
    L, age, P = L[order], age[order], P[order]
    for i in range(slots):
        reqs.append({"prompt": tokens(rng, vocab, int(P[i] + age[i])),
                     "max_new": int(L[i] - age[i]), "due_s": 0.0,
                     "initial": True})
    n = int(params["n_backlog"])
    P = uniform_ints(p_lo, p_hi, n, rng)
    O = uniform_ints(o_lo, o_hi, n, rng)
    for i in range(n):
        reqs.append({"prompt": tokens(rng, vocab, int(P[i])),
                     "max_new": int(O[i]), "due_s": 0.0, "initial": False})
    for rid, r in enumerate(reqs):
        r["rid"] = rid
    return reqs
