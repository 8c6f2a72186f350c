"""Port parity: speculative decode on the paged batcher.

The reference's ``tests/test_spec_decode.py`` cases that the port runs
(its gemma3 and MLA layout cases wait for those layouts; deadline
expiry, the verify-fault unwind and supervised recovery for the
resilience slice), on the same weights (JAX's ``registry.init(cfg, 0)``
carried across with ``params_from_numpy``): speculative decode streams
plain greedy decode's tokens on flat bf16, int8 and ``decode_flash``
pages, on random prompts, under forced rejection (the drafter
self-disables), under pool-pressure preemption and beside a prefix
re-hit; the probe schedule gates a disabled drafter.  Across
frameworks: the port's batcher streams the JAX batcher's tokens with the
same speculation counters (with the prefix cache and ``prefill_exact``
on), and ``forward(mode="verify")`` gives the JAX logits to
``LOGIT_TOL`` with pools to one bf16 ulp (int8: one step at near-ties),
bf16 and int8, with and without ``decode_flash``.  Inside the port: a
verify span scores like sequential decode steps, and the verify step
masks its drop-mode padding and leaves the batcher's table alone.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import params as jparams
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.serve_loop import make_spec_verify_step

torch.set_num_threads(2)

PAGE = 8
MAX_SEQ = 32
# as tests/test_torch_model.py: fp32 logits read through bf16 (int8)
# pools whose elements may round to the neighbouring value.
LOGIT_TOL = 1e-3
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _spec_cfg(cfg, k=4, **kw):
    # speculate_ngram=1: the permissive single-token drafter, so short
    # smoke runs draft early and often (as the reference's tests do).
    base = dict(kv_page_size=PAGE, prefill_chunk=PAGE, speculate_k=k,
                speculate_ngram=1)
    base.update(kw)
    return dataclasses.replace(cfg, **base)


def _plain_cfg(cfg, **kw):
    return _spec_cfg(cfg, k=0, **kw)


def _repetitive_prompts(plens):
    """Motif-cycled prompts, so the n-gram drafter fires."""
    motif = np.asarray([7, 3, 11, 5], np.int32)
    return [np.tile(motif, L // 4 + 1)[:L].astype(np.int32) for L in plens]


def _random_prompts(cfg, plens):
    return [np.random.default_rng(L).integers(0, cfg.vocab_size, L).astype(
        np.int32) for L in plens]


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=MAX_SEQ,
         **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [drain(r) for r in reqs], bat


def _check_allocators(bat):
    assert bat.total_used_pages() == (bat._prefix.n_pages
                                      if bat._prefix is not None else 0)
    for alloc in bat._alloc.values():
        alloc.check_consistency()


# --- bit-identity on the flat layouts --------------------------------------------------


@pytest.mark.parametrize("extra", [{}, {"kv_cache_dtype": "int8"},
                                   {"decode_flash": True}])
def test_spec_bit_identical_across_layouts(model, extra):
    base, tp, _, _ = model
    cfg = dataclasses.replace(base, **extra)
    prompts = _repetitive_prompts([9, 14, 6, 12])
    max_news = [16, 16, 16, 16]
    plain, _ = _run(_plain_cfg(cfg), tp, prompts, max_news, max_seq=48)
    spec, bat = _run(_spec_cfg(cfg), tp, prompts, max_news, max_seq=48)
    assert spec == plain
    st = bat.stats()["speculation"]
    assert st["drafted"] > 0, "repetitive workload must actually draft"
    assert st["drafted"] == st["accepted"] + st["rolled_back"]
    _check_allocators(bat)


def test_spec_bit_identical_random_workload(model):
    cfg, tp, _, _ = model
    prompts = _random_prompts(cfg, [9, 14, 6, 12])
    max_news = [10, 14, 12, 8]
    plain, _ = _run(_plain_cfg(cfg), tp, prompts, max_news)
    spec, bat = _run(_spec_cfg(cfg), tp, prompts, max_news)
    assert spec == plain
    _check_allocators(bat)


# --- forced rejection + self-disable ----------------------------------------------------


def test_forced_rejection_rolls_back_and_self_disables(model):
    cfg, tp, _, _ = model
    prompts = _repetitive_prompts([9, 12])
    max_news = [16, 16]
    plain, _ = _run(_plain_cfg(cfg), tp, prompts, max_news)
    bat = ContinuousBatcher(_spec_cfg(cfg), tp, n_slots=2, max_seq=MAX_SEQ,
                            device="cpu")
    bat._draft = lambda slot: (
        [] if bat._accept_ewma[slot] < bat.speculate_min_accept
        else [1, 2, 3])
    reqs = [Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    assert [drain(r) for r in reqs] == plain
    st = bat.stats()["speculation"]
    assert st["rolled_back"] > 0
    assert st["verify_steps"] <= 10
    assert bat.steps > st["verify_steps"], "plain path must take over"
    _check_allocators(bat)


def test_probe_schedule_gates_drafting(model):
    cfg, tp, _, _ = model
    bat = ContinuousBatcher(_spec_cfg(cfg, speculate_ngram=3), tp,
                            n_slots=2, max_seq=MAX_SEQ, device="cpu")
    bat._history[0] = [7, 3, 11, 5] * 6
    bat._host_remaining[0] = 10
    assert bat._draft(0), "enabled slot must draft"
    bat._accept_ewma[0] = 0.0
    bat._probe_at[0] = 8
    bat.steps = 7
    assert not bat._draft(0), "before probe_at: no probe"
    bat.steps = 9
    assert not bat._draft(0), "off the probe grid: no probe"
    bat.steps = 2 * bat.speculate_probe
    assert bat._draft(0), "grid tick past probe_at: probe drafts"
    bat._probe_at[0] = bat.steps + 1
    assert not bat._draft(0), "backed off past this tick: no probe"
    bat._history[0] = list(range(30))
    bat._probe_gap[0] = 4
    bat._probe_at[0] = bat.steps
    assert not bat._draft(0), "novel history: probe scan finds nothing"
    assert bat._probe_gap[0] == 8, "no-match probe doubles the gap"
    assert bat._probe_at[0] == bat.steps + 8


# --- preemption, prefix sharing, dense slots --------------------------------------------


def test_spec_survives_pool_pressure_preemption(model):
    cfg, tp, _, _ = model
    prompts = _repetitive_prompts([9, 12, 7, 10])
    max_news = [12, 12, 10, 10]
    plain, _ = _run(_plain_cfg(cfg), tp, prompts, max_news, n_slots=4)
    spec, bat = _run(_spec_cfg(cfg), tp, prompts, max_news, n_slots=4,
                     n_pages=9)
    assert spec == plain
    assert bat.preemptions > 0, "pool must actually be contended"
    assert bat.total_used_pages() == 0
    _check_allocators(bat)


def test_prefix_rehit_unaffected_by_speculating_sharer(model):
    cfg, tp, _, _ = model
    prompt = _repetitive_prompts([12])[0]

    def serve(scfg):
        bat = ContinuousBatcher(scfg, tp, n_slots=2, max_seq=MAX_SEQ,
                                device="cpu")
        outs = []
        for rid in range(3):               # cold, rehit, rehit-after-spec
            r = Request(rid=rid, prompt=prompt.copy(), max_new=12)
            bat.submit(r)
            bat.run(rid + 1)
            outs.append(drain(r))
        return outs, bat

    plain, _ = serve(_plain_cfg(cfg, prefix_cache=True))
    spec, bat = serve(_spec_cfg(cfg, prefix_cache=True))
    assert spec == plain
    assert spec[1] == spec[0] and spec[2] == spec[0]
    st = bat.stats()
    assert st["prefix_hits"] >= 2
    assert st["speculation"]["drafted"] > 0
    _check_allocators(bat)


def test_dense_slots_switch_speculation_off(model):
    cfg, tp, _, _ = model
    prompts = _repetitive_prompts([9, 12])
    c = dataclasses.replace(cfg, speculate_k=4, speculate_ngram=1)
    spec, bat = _run(c, tp, prompts, [8, 8])
    plain, _ = _run(cfg, tp, prompts, [8, 8])
    assert not bat.paged and bat.speculate_k == 0
    assert spec == plain


# --- the verify step ---------------------------------------------------------------------


def _prefilled(cfg, params, mod="torch", n_pages=10):
    """Pools of two sequences prefilled in two chunks each through the
    port (``mod="torch"``) or the JAX package, as
    ``tests/test_torch_model.py`` builds them."""
    bt = np.asarray([[7, 2, 9, n_pages], [0, 5, 3, 8]], np.int32)
    rng = np.random.default_rng(3)
    chunks = [((0, 0), (7, 7)), ((8, 8), (7, 4))]
    if mod == "torch":
        pools = tparams.init_params(tregistry.paged_cache_decls(
            cfg, n_pages, PAGE), device="cpu")
    else:
        pools = jparams.init_params(jregistry.paged_cache_decls(
            cfg, n_pages, PAGE))
    for pos0, last in chunks:
        tok = rng.integers(0, 512, (2, 8)).astype(np.int32)
        pos0, last = (np.asarray(a, np.int32) for a in (pos0, last))
        if mod == "torch":
            _, pools = tregistry.forward(
                cfg, params, {"tokens": torch.from_numpy(tok).long()},
                mode="chunk", cache={"pages": pools, "block_tab": {
                    "kv": torch.from_numpy(bt)}},
                pos=torch.from_numpy(pos0), last_pos=torch.from_numpy(last),
                cache_offset=torch.zeros(2, dtype=torch.int32))
        else:
            _, pools = jregistry.forward(
                cfg, params, {"tokens": jnp.asarray(tok)}, mode="chunk",
                cache={"pages": pools, "block_tab": {"kv": jnp.asarray(bt)}},
                pos=jnp.asarray(pos0), last_pos=jnp.asarray(last),
                cache_offset=jnp.zeros((2,), jnp.int32))
    return pools, bt


@pytest.mark.parametrize("decode_flash", [False, True])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_verify_logits_match_jax(model, kv, decode_flash):
    """A (2, 5) verify span at positions 16 and 13 over prefilled pools:
    full logits to LOGIT_TOL of the JAX package's, the pools after the
    span to one bf16 ulp (int8: values one step apart at near-ties only,
    scales to one bf16 ulp)."""
    cfg, tp, jcfg, jp = model
    kw = dict(kv_page_size=PAGE, kv_cache_dtype=kv, decode_flash=decode_flash)
    tcfg = dataclasses.replace(cfg, **kw)
    jcfg = dataclasses.replace(jcfg, **kw)
    tpools, bt = _prefilled(tcfg, tp)
    jpools, _ = _prefilled(jcfg, jp, mod="jax")
    tok = np.random.default_rng(5).integers(0, 512, (2, 5)).astype(np.int32)
    pos = np.asarray([16, 13], np.int32)
    jl, jpools = jregistry.forward(
        jcfg, jp, {"tokens": jnp.asarray(tok)}, mode="verify",
        cache={"pages": jpools, "block_tab": {"kv": jnp.asarray(bt)}},
        pos=jnp.asarray(pos))
    tl, tpools = tregistry.forward(
        tcfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="verify",
        cache={"pages": tpools, "block_tab": {"kv": torch.from_numpy(bt)}},
        pos=torch.from_numpy(pos))
    assert tl.shape == (2, 5, cfg.padded_vocab) == jl.shape
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_TOL
    for leaf in ("k", "v"):
        t, j = tpools["kv"][leaf], jpools["kv"][leaf]
        if kv == "int8":
            diff = np.abs(t.numpy().astype(int) - np.asarray(j))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            ts = tpools["kv"][leaf + "_scale"].float().numpy()
            sdiff = np.abs(ts - np.asarray(jpools["kv"][leaf + "_scale"],
                                           np.float32))
            assert np.all(sdiff <= 2.0 ** -8 * np.abs(ts))
        else:
            diff = np.abs(t.float().numpy()
                          - np.asarray(j.astype(jnp.float32)))
            assert diff.max() <= CACHE_TOL


@pytest.mark.parametrize("decode_flash", [False, True])
def test_verify_span_scores_like_sequential_decode(model, decode_flash):
    """Rows 0..k of one verify span against k + 1 decode steps from a
    copy of the same pools: the same greedy tokens, logits to LOGIT_TOL
    and the pools to one bf16 ulp (the gather path's softmax spans S + k
    keys instead of S + 1, so its sums run in another order)."""
    cfg, tp, _, _ = model
    cfg = dataclasses.replace(cfg, kv_page_size=PAGE,
                              decode_flash=decode_flash)
    pools, bt = _prefilled(cfg, tp)
    seq = tparams.tree_map(lambda _, a: a.clone(), pools)
    tok = np.random.default_rng(6).integers(0, 512, (2, 5)).astype(np.int32)
    pos = torch.tensor([16, 13], dtype=torch.int32)
    cache = {"block_tab": {"kv": torch.from_numpy(bt)}}
    vl, pools = tregistry.forward(
        cfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="verify",
        cache={**cache, "pages": pools}, pos=pos)
    for i in range(5):
        dl, seq = tregistry.forward(
            cfg, tp, {"tokens": torch.from_numpy(tok[:, i:i + 1]).long()},
            mode="decode", cache={**cache, "pages": seq}, pos=pos + i)
        assert float((dl[:, 0] - vl[:, i]).abs().max()) <= LOGIT_TOL, i
        assert torch.equal(dl[:, 0].argmax(-1), vl[:, i].argmax(-1)), i
    for leaf in ("k", "v"):
        diff = (pools["kv"][leaf].float() - seq["kv"][leaf].float()).abs()
        assert float(diff.max()) <= CACHE_TOL, leaf


def test_verify_step_masks_padding_and_keeps_the_table(model):
    """The verify step's copies and table swap skip their drop-mode
    padding (dst == n_pages, row == n_slots) and touch a copy of the
    table only; the scratch page holds the old page's prefix."""
    cfg, tp, _, _ = model
    cfg = dataclasses.replace(cfg, kv_page_size=PAGE)
    pools, bt = _prefilled(cfg, tp)
    n_pages = 10
    tab = torch.from_numpy(bt.copy())
    old = pools["kv"]["k"][:, 9].clone()
    fn = make_spec_verify_step(cfg, 5, MAX_SEQ, PAGE)
    xfer = ({"kv": np.asarray([9, 0, 0, 0], np.int32)},
            {"kv": np.asarray([4, n_pages, n_pages, n_pages], np.int32)},
            {"kv": np.asarray([0, 2, 2, 2], np.int32)},
            {"kv": np.asarray([2, 0, 0, 0], np.int32)},
            {"kv": np.asarray([4, 0, 0, 0], np.int32)})
    tokens = torch.from_numpy(np.asarray([[1, 2, 3, 4, 5], [6, 6, 6, 6, 6]],
                                         np.int32))
    pools, last_tok, pos, remaining, active, out = fn(
        tp, pools, {"kv": tab}, tokens, torch.tensor([4, 0],
                                                     dtype=torch.int32),
        torch.tensor([16, 13], dtype=torch.int32),
        torch.tensor([10, 10], dtype=torch.int32),
        torch.tensor([True, True]), *xfer)
    assert torch.equal(tab, torch.from_numpy(bt)), "batcher table touched"
    assert torch.equal(pools["kv"]["k"][:, 9], old), "old page rewritten"
    # positions 16..20 of row 0 went to scratch page 4 (offsets 0..4).
    new = pools["kv"]["k"][:, 4]
    assert new[:, :, :5].abs().sum() > 0
    assert out.shape == (7, 2) and out.dtype == torch.int32
    commit = out[5]
    assert int(commit[1]) == 1 and 1 <= int(commit[0]) <= 5
    assert torch.equal(pos, torch.tensor([16, 13], dtype=torch.int32)
                       + commit)


# --- across frameworks ----------------------------------------------------------------


@pytest.mark.parametrize("decode_flash", [False, True])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_spec_batcher_matches_jax_batcher(model, kv, decode_flash):
    """Speculation with the prefix cache and prefill_exact on: the port
    streams the JAX batcher's tokens, with its speculation and prefix
    counters, steps and chunks, and ends with only the index's pages."""
    cfg, tp, jcfg, jp = model
    prompts = _repetitive_prompts([9, 14, 6, 12])
    prompts += prompts[:2]
    kw = dict(prefix_cache=True, prefill_exact=True, kv_cache_dtype=kv,
              decode_flash=decode_flash)
    jbat = jbatching.ContinuousBatcher(_spec_cfg(jcfg, **kw), jp, n_slots=2,
                                       max_seq=48)
    jreqs = [jbatching.Request(rid=i, prompt=p, max_new=16)
             for i, p in enumerate(prompts)]
    prod = threading.Thread(target=lambda: [jbat.submit(r) for r in jreqs])
    prod.start()
    jbat.run(len(jreqs))
    prod.join()
    gold = [jbatching.drain(r) for r in jreqs]
    got, bat = _run(_spec_cfg(cfg, **kw), tp, prompts, [16] * len(prompts),
                    max_seq=48)
    assert got == gold
    plain, _ = _run(_plain_cfg(cfg, **kw), tp, prompts, [16] * len(prompts),
                    max_seq=48)
    assert got == plain
    st, jst = bat.stats(), jbat.stats()
    keys = ("drafted", "accepted", "rolled_back", "verify_steps")
    assert {k: st["speculation"][k] for k in keys} \
        == {k: jst["speculation"][k] for k in keys}
    keys = ("prefix_hits", "prefix_hit_tokens", "cow_copies", "steps",
            "prefill_chunks")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["speculation"]["drafted"] > 0 and st["prefix_hits"] > 0
    _check_allocators(bat)
