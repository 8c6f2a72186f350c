"""Traffic generators, one module per kind of load, found by the name a
traffic file gives under ``generator``.  Each exposes ``generate(params,
seed, **cell)`` and returns plain data: the harness hands it to the
program unchanged.

Every seed draws the same set of sizes (quantiles of the stated
distributions), in another order: the seed changes which request
gets which size and the token ids, not the amount of work, so two seeds
differ by little more than two runs of one seed."""

from __future__ import annotations

import numpy as np


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any non-negative integer) and a
    stream id."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def grid(n: int) -> np.ndarray:
    """n evenly spaced probabilities in (0, 1): the midpoints of n equal
    bins."""
    return (np.arange(n) + 0.5) / n


def uniform_ints(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n integers spread evenly over [lo, hi], in a stratified order from
    ``rng``."""
    return stratified(np.floor(lo + grid(n) * (hi - lo + 1)).astype(
        np.int64).clip(lo, hi), rng)


def stratified(values: np.ndarray, rng, block: int = 16) -> np.ndarray:
    """``values`` in an order from ``rng`` in which every run of
    ``block`` consecutive entries holds one value of each of ``block``
    equal strata of their range: any prefix of whole blocks holds the
    same sizes whatever the seed, so a window that reaches the k-th
    request meets the same work."""
    v = np.sort(np.asarray(values))
    n = len(v) - len(v) % block
    if n == 0:
        return rng.permutation(v)
    strata = v[:n].reshape(block, n // block)
    cols = np.stack([rng.permutation(n // block) for _ in range(block)])
    out = np.take_along_axis(strata, cols, 1).T            # (rounds, block)
    out = np.stack([rng.permutation(r) for r in out]).reshape(-1)
    return np.concatenate([out, rng.permutation(v[n:])])


def tokens(rng, vocab: int, n: int) -> np.ndarray:
    return rng.integers(0, vocab, n).astype(np.int32)
