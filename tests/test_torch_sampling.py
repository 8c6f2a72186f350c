"""Port parity: temperature sampling, reserve-at-admission and the serving
example (``serve/serve_loop.py``, ``serve/batching.py``,
``examples/serve_lm.py``).

JAX's RNG cannot be reproduced in torch, so sampling is held to its
properties: tokens in ``[0, padded_vocab)``, one seed one stream, other
seeds other streams, temperature -> 0 equal to greedy, temperature 0 the
argmax path bit for bit, and the drawn frequencies of a fixed row within
4 sigma of ``softmax(logits / T)``.  Reserve-at-admission admits the JAX
batcher's counts at the same pool and streams the lazy batcher's tokens;
the ``serve_lm`` twin prints the reference example's summary.  The
audio family samples (b, steps, K) tokens under the same properties.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve import batching as tbatching
from repro_torch.serve.serve_loop import (_sample_last, greedy_generate,
                                          make_sampling_serve_steps)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, n)).astype(np.int32)


def _generate(cfg, params, prompt, **kw):
    return greedy_generate(cfg, params, {"tokens": prompt}, steps=6,
                           max_seq=24, device="cpu", **kw)


def test_temperature_sampling_runs(model):
    """The reference's test on the port: shape and token range."""
    cfg, tp, _, _ = model
    out = _generate(cfg, tp, _prompt(cfg, 8, 1)[:1], temperature=1.0,
                    seed=7)
    assert out.shape == (1, 6) and out.dtype == np.int32
    assert (out >= 0).all() and (out < cfg.padded_vocab).all()


def test_seed_determines_the_stream(model):
    cfg, tp, _, _ = model
    prompt = _prompt(cfg, 8, 2)
    a = _generate(cfg, tp, prompt, temperature=1.5, seed=3)
    b = _generate(cfg, tp, prompt, temperature=1.5, seed=3)
    np.testing.assert_array_equal(a, b)
    others = [_generate(cfg, tp, prompt, temperature=1.5, seed=s)
              for s in (4, 5, 6)]
    assert all(not np.array_equal(a, o) for o in others)
    # at T = 1.5 over a 2048-column row the streams are not greedy.
    assert not np.array_equal(a, _generate(cfg, tp, prompt))


def test_temperature_to_zero_is_greedy(model):
    """T = 0 is the argmax path bit for bit (the steps' logits through
    ``torch.argmax``, and the JAX package's greedy tokens on the bridged
    weights); a vanishing temperature samples the same tokens."""
    cfg, tp, jcfg, jp = model
    prompt = _prompt(cfg, 8, 3)
    greedy = _generate(cfg, tp, prompt)
    np.testing.assert_array_equal(
        greedy, jgreedy(jcfg, jp, {"tokens": prompt}, steps=6, max_seq=24))
    np.testing.assert_array_equal(
        greedy, _generate(cfg, tp, prompt, temperature=1e-6, seed=9))
    # the decode step at T = 0 returns exactly the logits' argmax.
    pre, dec = make_sampling_serve_steps(cfg, 24)
    tok = torch.as_tensor(prompt).long()
    nxt, cache = pre(tp, {"tokens": tok},
                     torch.full((2,), 7, dtype=torch.int64))
    logits, _ = tregistry.forward(cfg, tp, {"tokens": tok}, mode="prefill",
                                  cache_len=24,
                                  last_pos=torch.full((2,), 7))
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, torch.argmax(logits[:, -1], -1).int())
    assert torch.equal(nxt, _sample_last(logits[:, -1], None, 0.0))


def test_audio_codebooks_sample(model):
    """musicgen (the audio family) at T = 1: (b, steps, K) tokens over its
    four codebooks in ``[0, padded_vocab)``, the Gumbel draw covering
    every (row, codebook) logit; one seed one stream, another seed
    another (JAX's RNG cannot be reproduced, so properties only)."""
    jcfg = jsmoke(jconfigs.get("musicgen-medium"))
    cfg = tsmoke(tconfigs.get("musicgen-medium"))
    params = tparams.params_from_numpy(tparams.tree_map(
        lambda _, a: np.asarray(a), jregistry.init(jcfg, 0)), "cpu")
    prompt = {k: np.asarray(v) for k, v in
              jregistry.make_batch(jcfg, "prefill", 2, 5, seed=2).items()}

    def sample(seed):
        return greedy_generate(cfg, params, prompt, steps=6, max_seq=16,
                               temperature=1.0, seed=seed, device="cpu")

    a = sample(3)
    assert a.shape == (2, 6, cfg.n_codebooks) and a.dtype == np.int32
    assert (a >= 0).all() and (a < cfg.padded_vocab).all()
    np.testing.assert_array_equal(a, sample(3))
    assert not np.array_equal(a, sample(4))
    # the codebooks draw their own columns, not one draw repeated.
    assert not all(np.array_equal(a[..., 0], a[..., c])
                   for c in range(1, cfg.n_codebooks))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
def test_draw_frequencies_follow_softmax(temperature):
    """20 000 draws of one fixed 8-column row: each column's frequency
    within 4 sigma of softmax(logits / T)."""
    n = 20000
    row = torch.tensor([1.5, -0.5, 0.0, 2.0, -3.0, 0.7, 1.1, -1.2])
    gen = torch.Generator(device="cpu").manual_seed(int(temperature * 10))
    draws = _sample_last(row.expand(n, -1), gen, temperature)
    assert draws.dtype == torch.int32
    assert int(draws.min()) >= 0 and int(draws.max()) < row.numel()
    freq = torch.bincount(draws.long(), minlength=row.numel()).double() / n
    p = torch.softmax(row.double() / temperature, -1)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert bool((torch.abs(freq - p) <= 4 * sigma).all()), (freq, p)


def _fill(batching, cfg, params, reserve, **kw):
    """The reference's bursty admission: 8 one-page prompts of 28 new
    tokens on 8 slots and an 8-page pool; admit and prefill until
    nothing more fits, count the slots in flight, then serve it all."""
    c = dataclasses.replace(cfg, kv_page_size=8, kv_reserve_decode=reserve)
    bat = batching.ContinuousBatcher(c, params, n_slots=8, max_seq=64,
                                     n_pages=8, **kw)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, 4).astype(np.int32)
    reqs = [batching.Request(rid=i, prompt=prompt, max_new=28)
            for i in range(8)]
    for r in reqs:
        bat.submit(r)
    progress = True
    while progress:
        progress = bat.admit() > 0
        while bat._admitting:
            bat._prefill_step()
            progress = True
    inflight = sum(r is not None for r in bat._slot_req)
    bat.run(len(reqs))
    outs = [batching.drain(r, timeout=10.0) for r in reqs]
    assert bat.total_used_pages() == 0
    return inflight, outs, bat


def test_lazy_admits_more_than_reserve_at_equal_pool(model):
    """At an 8-page pool, 1-page prompts with a 4-page worst case: lazy
    growth admits 8, reserve-at-admission 2, as the JAX batcher does;
    reserve streams the lazy batcher's tokens and never preempts."""
    cfg, tp, jcfg, jp = model
    lazy, lazy_out, lazy_bat = _fill(tbatching, cfg, tp, False,
                                     device="cpu")
    res, res_out, res_bat = _fill(tbatching, cfg, tp, True, device="cpu")
    j_lazy = _fill(jbatching, jcfg, jp, False)[0]
    j_res = _fill(jbatching, jcfg, jp, True)[0]
    assert (lazy, res) == (j_lazy, j_res) == (8, 2)
    assert res_out == lazy_out
    assert all(len(o) == 28 for o in res_out)
    assert res_bat.reserve_decode and not lazy_bat.reserve_decode
    assert res_bat.preemptions == 0 and lazy_bat.preemptions > 0


def test_reserve_copies_a_partial_prefix_page_at_admission(model):
    """A prompt whose whole length matches a cached prefix, ending
    mid-page: under reserve the boundary page is copied at admission
    (decode never reaches the growth path's copy-on-write), and the hit
    streams the cold run's tokens."""
    cfg, tp, _, _ = model
    c = dataclasses.replace(cfg, kv_page_size=8, prefill_chunk=8,
                            prefix_cache=True, kv_reserve_decode=True)
    long_p = np.random.default_rng(6).integers(
        0, cfg.vocab_size, 16).astype(np.int32)
    bat = tbatching.ContinuousBatcher(c, tp, n_slots=1, max_seq=32,
                                      device="cpu")
    outs = []
    for rid, prompt in enumerate((long_p, long_p[:12])):
        r = tbatching.Request(rid=rid, prompt=prompt, max_new=6)
        bat.submit(r)
        bat.run(rid + 1)
        outs.append(tbatching.drain(r, timeout=10.0))
    assert bat.prefix_hits == 1 and bat.prefix_hit_tokens == 12
    assert bat.cow_copies == 1
    cold = greedy_generate(cfg, tp, {"tokens": long_p[None, :12]}, steps=6,
                           max_seq=32, device="cpu")[0]
    assert outs[1] == list(cold)


def _summary(cmd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 8
    return re.sub(r"in [0-9.]+s \([0-9.]+ tok/s", "in Ts (R tok/s",
                  lines[-1])


def test_serve_lm_twin_prints_the_reference_summary():
    got = _summary([sys.executable, "-m", "repro_torch.examples.serve_lm",
                    "--device", "cpu"])
    want = _summary([sys.executable, str(ROOT / "examples" /
                                          "serve_lm.py")])
    assert got == want
    assert got.startswith("8 requests, 96 tokens in Ts (R tok/s, ")
