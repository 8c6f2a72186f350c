"""Port parity: deepseek-v2-lite (smoke width, fp32) served on latent pages.

The serve contracts the reference holds for MLA, held inside the port
bit for bit — twins of
``tests/test_paged_kv.py::test_structured_layouts_paged_match_dense
[deepseek-v2-lite-16b-kw1]``,
``tests/test_prefix_cache.py::test_hit_token_identical_across_shareable_layouts
[deepseek-v2-lite-16b-kw1]``,
``tests/test_spec_decode.py::test_spec_bit_identical_across_layouts
[deepseek-v2-lite-16b-extra4]`` and the MLA case of
``tests/test_kv_tiers.py::test_demote_rehit_token_identical_across_layouts``
— plus preempt/resume == never preempted and a copy-on-write hit on
latent pages; across frameworks, the port's batcher streams the JAX
batcher's tokens, paged and dense (same weights, JAX's
``registry.init(cfg, 0)`` carried across with ``params_from_numpy``).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.models.cache_layouts import get_layout
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.serve_loop import greedy_generate

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get(ARCH))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tsmoke(tconfigs.get(ARCH)), jp, tp


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(
        np.int32)


def _greedy(cfg, params, prompt, steps, max_seq=64):
    return list(greedy_generate(cfg, params, {"tokens": prompt[None]},
                                steps=steps, max_seq=max_seq,
                                device="cpu")[0])


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=48, **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=30)
    return [drain(r, timeout=30) for r in reqs], bat


def _serve_seq(bat, prompts, max_news):
    """Requests one after another through a LIVE batcher (the prefix
    index and the host tier accumulate across them)."""
    outs = []
    for i, (p, mn) in enumerate(zip(prompts, max_news)):
        r = Request(rid=100 + i, prompt=p, max_new=mn)
        t = threading.Thread(target=lambda r=r: bat.submit(r))
        t.start()
        bat.run(bat.retired + 1)
        t.join(timeout=30)
        outs.append(drain(r, timeout=30))
    return outs


def _check_allocators(bat):
    assert bat.total_used_pages() == (bat._prefix.n_pages
                                      if bat._prefix is not None else 0)
    for alloc in bat._alloc.values():
        alloc.check_consistency()


def test_structured_layouts_paged_match_dense(model):
    """Twin of the reference's deepseek case: latent pages give the dense
    batcher's tokens (prompts in one prefill chunk), every page back."""
    _, cfg, _, tp = model
    prompts = [_prompt(n, n) for n in (5, 12, 21)]
    max_news = [4, 3, 4]
    gold, _ = _run(cfg, tp, prompts, max_news)
    paged = dataclasses.replace(cfg, kv_page_size=8)
    assert tregistry.paged_supported(paged)
    got, bat = _run(paged, tp, prompts, max_news, prefill_chunk=32)
    assert bat.paged and bat.layout.groups[0].name == "latent"
    assert got == gold
    assert bat.total_used_pages() == 0


def test_preempt_resume_equals_never_preempted(model):
    """A pool too small for both slots' growth preempts: the spilled
    latent pages (every leaf of the nested pools) come back bit for bit,
    and the tokens equal an unpreempted run's."""
    _, cfg, _, tp = model
    cfg = dataclasses.replace(cfg, kv_page_size=8, prefill_chunk=8)
    prompts = [_prompt(n, 40 + n) for n in (9, 14, 6, 12)]
    max_news = [14, 12, 14, 10]
    gold, big = _run(cfg, tp, prompts, max_news)
    got, bat = _run(cfg, tp, prompts, max_news, n_pages=5)
    assert big.preemptions == 0 and bat.preemptions > 0
    assert got == gold
    _check_allocators(bat)


def test_hit_token_identical_on_latent_pages(model):
    """Twin of the reference's deepseek case of
    test_hit_token_identical_across_shareable_layouts."""
    _, cfg, _, tp = model
    assert get_layout(cfg, 8).prefix_shareable
    P = _prompt(24, seed=11)
    pcfg = dataclasses.replace(cfg, kv_page_size=8, prefix_cache=True)
    bat = ContinuousBatcher(pcfg, tp, n_slots=2, max_seq=64, device="cpu")
    cold, hit = _serve_seq(bat, [P, P], [5, 5])
    assert hit == cold == _greedy(cfg, tp, P, 5)
    assert bat.prefix_hits == 1


def test_copy_on_write_hit_on_latent_pages(model):
    """Both copy-on-write triggers on latent pages (both leaves of both
    layer stacks copied): a prompt diverging mid-page (the catch-up
    prefill writes into the shared page) and a strict prefix (decode
    grows into it).  Every request gives its cold paged tokens — the
    oracle is a cold batcher with the same chunking, not
    ``greedy_generate``: MoE capacity is per call, so a 24-token prefill
    in one call can drop other copies than chunks of 16 and 8 (as in
    the reference)."""
    _, cfg, _, tp = model
    P = _prompt(24, seed=13)
    P2 = P.copy()
    P2[20:] = (P2[20:] + 7) % cfg.vocab_size
    seq = [P, P2, P[:20], P]
    pcfg = dataclasses.replace(cfg, kv_page_size=8, prefix_cache=True)
    bat = ContinuousBatcher(pcfg, tp, n_slots=2, max_seq=64, device="cpu")
    out = _serve_seq(bat, seq, [5] * 4)
    cold, _ = _run(dataclasses.replace(pcfg, prefix_cache=False), tp, seq,
                   [5] * 4, n_slots=1, max_seq=64)
    assert out == cold
    assert bat.cow_copies >= 2 and bat.prefix_hits >= 3
    _check_allocators(bat)


def test_spec_bit_identical_on_latent_pages(model):
    """Twin of the reference's deepseek case of
    test_spec_bit_identical_across_layouts: verify spans read their own
    latent rows pool-rounded, so speculation streams plain decode's
    tokens."""
    _, cfg, _, tp = model
    motif = np.asarray([7, 3, 11, 5], np.int32)
    prompts = [np.tile(motif, n // 4 + 1)[:n] for n in (9, 14, 6, 12)]
    base = dict(kv_page_size=8, prefill_chunk=8, speculate_ngram=1)
    plain, _ = _run(dataclasses.replace(cfg, speculate_k=0, **base), tp,
                    prompts, [16] * 4)
    spec, bat = _run(dataclasses.replace(cfg, speculate_k=4, **base), tp,
                     prompts, [16] * 4)
    assert spec == plain
    st = bat.stats()["speculation"]
    assert st["drafted"] > 0
    assert st["drafted"] == st["accepted"] + st["rolled_back"]
    _check_allocators(bat)


def test_demote_rehit_token_identical_on_latent_pages(model):
    """The MLA case of test_demote_rehit_token_identical_across_layouts:
    a one-slot batcher on a 6-page pool demotes P's blocks to the host
    tier while serving F, and P's rehit promotes them back (nested
    latent payloads) with the cold run's tokens and those of a hit on
    device-resident pages."""
    _, cfg, _, tp = model
    P, F = _prompt(32, seed=42), _prompt(32, seed=43)
    tcfg = dataclasses.replace(
        cfg, kv_page_size=8, prefill_chunk=8, prefix_cache=True,
        kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=0)
    bat = ContinuousBatcher(tcfg, tp, n_slots=1, max_seq=64, n_pages=6,
                            device="cpu")
    cold, _, hit = _serve_seq(bat, [P, F, P], [5, 5, 5])
    assert hit == cold
    t = bat._tiers.stats()
    assert t["demotions"] >= 1 and t["rehits"] >= 1
    # the same rehit from device-resident pages (a pool that keeps P).
    dev = ContinuousBatcher(tcfg, tp, n_slots=1, max_seq=64, n_pages=16,
                            device="cpu")
    _, _, dev_hit = _serve_seq(dev, [P, F, P], [5, 5, 5])
    assert dev.prefix_hits >= 1 and dev._tiers.stats()["rehits"] == 0
    assert hit == dev_hit


def _jrun(cfg, params, prompts, max_news, **kw):
    bat = jbatching.ContinuousBatcher(cfg, params, **kw)
    reqs = [jbatching.Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [jbatching.drain(r) for r in reqs]


@pytest.mark.parametrize("page", [8, 0])
def test_batcher_matches_jax_batcher(model, page):
    """The port's batcher streams the JAX batcher's tokens on latent
    pages (two prompt chunks for the longest) and from dense slots."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, kv_page_size=page)
    tcfg = dataclasses.replace(tcfg, kv_page_size=page)
    prompts = [_prompt(n, 30 + n) for n in (5, 12, 21)]
    max_news = [4, 3, 4]
    gold = _jrun(jcfg, jp, prompts, max_news, n_slots=2, max_seq=48)
    got, bat = _run(tcfg, tp, prompts, max_news)
    assert bat.paged == bool(page)
    assert got == gold
