"""Port parity: the MoE layer and phi3.5-moe (smoke width, fp32).

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``) and the same numpy-made inputs go through both
packages: the routing of ``moe_apply`` (expert ids, capacity slots,
kept copies) exactly, ties included, its output to 1e-5; the
reference's MoE invariants mirrored (``tests/test_models.py``,
``tests/test_perf_flags.py``); per-row capacity on dense slots against
``jax.vmap`` of a one-row decode; phi3.5's train, prefill and decode
logits to ``LOGIT_TOL`` with caches to one bf16 ulp.  Paged forwards and the
batcher against JAX are in ``tests/test_torch_moe_serve.py``.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.batching import ContinuousBatcher, Request, drain

torch.set_num_threads(2)

ARCH = "phi3p5-moe-42b"
# as tests/test_torch_model.py: fp32 logits read through bf16 caches
# whose elements may round to the neighbouring value across frameworks.
LOGIT_TOL = 1e-3
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2
MOE_TOL = 1e-5               # one MoE layer, fp32, same routing


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get(ARCH))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tsmoke(tconfigs.get(ARCH)), jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _diff(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


def _moe_layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["blocks"]["moe"]),
            tparams.tree_map(lambda _, a: a[i], tp["blocks"]["moe"]))


def _both(cfg_j, cfg_t, **kw):
    return (dataclasses.replace(cfg_j, **kw),
            dataclasses.replace(cfg_t, **kw))


def _routing_equal(jcfg, tcfg, jm, tm, x2):
    _, (jf, js, jk, jg) = jlayers._moe_dispatch_combine(
        jcfg, jm, jnp.asarray(x2), jnp.float32)
    disp, (tf, ts, tk, tg) = tlayers._moe_dispatch(
        tcfg, tm, torch.from_numpy(x2)[None], torch.float32)
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk))
    assert _diff(tg[0], jg) < 1e-6
    return disp, (tf, ts, tk, tg)


@pytest.mark.parametrize("cf", [1.25, 0.05, 8.0])
def test_routing_matches_jax(model, cf):
    """Expert ids, capacity slots and kept copies equal the reference's
    exactly (cf 0.05 drops copies, 8 none); gates to 1e-6."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = _both(jcfg, tcfg, capacity_factor=cf)
    jm, tm = _moe_layer(jp, tp)
    x2 = np.random.default_rng(3).standard_normal(
        (64, jcfg.d_model)).astype(np.float32)
    _, (_, _, keep, _) = _routing_equal(jcfg, tcfg, jm, tm, x2)
    if cf != 1.25:
        assert bool(keep.all()) == (cf == 8.0)


@pytest.mark.parametrize("cf,groups", [(1.25, 0), (0.05, 0), (1.25, 4),
                                       (0.05, 4)])
def test_moe_apply_matches_jax(model, cf, groups):
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = _both(jcfg, tcfg, capacity_factor=cf, moe_groups=groups)
    jm, tm = _moe_layer(jp, tp, 1)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    gold = jlayers.moe_apply(jcfg, jm, jnp.asarray(x))
    got = tlayers.moe_apply(tcfg, tm, torch.from_numpy(x))
    assert _diff(got, gold) < MOE_TOL


def test_top_k_ties_pick_the_lower_expert(model):
    """Tied router logits: the port takes the experts ``lax.top_k`` takes
    (the lower index first) — two equal router columns, and all equal."""
    jcfg, tcfg, jp, tp = model
    jm, tm = _moe_layer(jp, tp)
    x2 = np.random.default_rng(5).standard_normal(
        (48, jcfg.d_model)).astype(np.float32)
    r = np.asarray(jm["router"]).copy()
    for cols in ((1, 2), (0, 3), None):
        rr = r.copy()
        if cols is None:
            rr[:] = rr[:, :1]
        else:
            rr[:, cols[1]] = rr[:, cols[0]]
        jm2 = dict(jm, router=jnp.asarray(rr))
        tm2 = dict(tm, router=torch.from_numpy(rr))
        _, (tf, _, _, _) = _routing_equal(jcfg, tcfg, jm2, tm2, x2)
        if cols is None:
            assert set(tf[0].tolist()) == {0, 1}
        else:
            # every token picks both tied experts or neither; where it
            # picks both, the lower index comes first.
            pairs = tf[0].reshape(-1, 2).tolist()
            both = [p for p in pairs if set(p) == set(cols)]
            assert both and all(p[0] == min(cols) for p in both)


def test_moe_dispatch_invariants(model):
    """Mirror of tests/test_models.py::test_moe_dispatch_invariants: every
    kept copy lands in exactly one (expert, slot), no expert above its
    capacity, and the dispatched rows are the tokens exactly."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, capacity_factor=8.0, top_k=1)
    tm = tparams.tree_map(lambda _, a: a[0], tp["blocks"]["moe"])
    x2 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    disp, (flat_e, safe_pos, keep, _) = tlayers._moe_dispatch(
        cfg, tm, x2[None], torch.float32)
    assert bool(keep.all()), "cf=8 must not drop"
    pairs = torch.stack([flat_e[0], safe_pos[0]], 1).tolist()
    assert len({tuple(r) for r in pairs}) == 64
    cap = disp.shape[1]
    for e in range(cfg.n_experts):
        assert int((flat_e == e).sum()) <= cap
    back = disp[flat_e[0], safe_pos[0]]
    torch.testing.assert_close(back, x2, rtol=1e-6, atol=0)


def test_moe_capacity_drops_are_zero_not_garbage(model):
    """Mirror of tests/test_models.py's test of that name: aggressive
    drops give finite logits — and the reference's logits."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = _both(jcfg, tcfg, capacity_factor=0.05)
    tok = _tokens((2, 32), 6)
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert not bool(torch.isnan(got).any())
    gold = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    assert _diff(got, gold) <= LOGIT_TOL


def test_moe_grouped_exact_without_drops(model):
    """Mirror of tests/test_perf_flags.py's test of that name: without
    drops, grouped dispatch gives the ungrouped logits bit for bit."""
    _, tcfg, _, tp = model
    big = dataclasses.replace(tcfg, capacity_factor=8.0)
    big_g = dataclasses.replace(tcfg, capacity_factor=8.0, moe_groups=4)
    tok = {"tokens": torch.from_numpy(_tokens((2, 32), 7)).long()}
    l1 = tregistry.forward(big, tp, tok)
    l2 = tregistry.forward(big_g, tp, tok)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)


def test_moe_groups_rule():
    """Group counts: the reference's ``T // G >= 8`` rule on shared
    capacity; each row alone (its s tokens by the same rule) on dense
    slots."""
    cfg = dataclasses.replace(tsmoke(tconfigs.get(ARCH)), moe_groups=4)
    assert tlayers.moe_groups(cfg, 2, 32) == 4
    assert tlayers.moe_groups(cfg, 2, 8) == 1       # 16 // 4 < 8
    assert tlayers.moe_groups(cfg, 8, 1, row_capacity=True) == 8
    assert tlayers.moe_groups(cfg, 3, 32, row_capacity=True) == 12
    cfg = dataclasses.replace(cfg, moe_groups=0)
    assert tlayers.moe_groups(cfg, 5, 7) == 1
    assert tlayers.moe_groups(cfg, 5, 7, row_capacity=True) == 5


def test_row_capacity_decode_matches_vmapped_jax(model):
    """Per-row capacity: 20 dense slots decode in one batched step.  With
    capacity factor 0.05 the shared capacity (8 copies per expert) must
    drop (40 copies over 4 experts), so idle rows ahead of a live one
    would take its expert places; each row alone never drops.  The
    port's step with ``row_capacity`` gives ``jax.vmap`` of a one-row
    JAX decode, and differs from the shared-capacity step.  Both decode
    from the JAX prefill's cache (bridged), so the step is compared on
    the same inputs: a cache element one bf16 ulp apart across
    frameworks moves a logit by up to ~1e-3 here, as in the other tests'
    ``LOGIT_TOL``."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = _both(jcfg, tcfg, capacity_factor=0.05)
    b, plen, max_seq = 20, 6, 16
    tok = _tokens((b, plen), 8)
    _, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              mode="prefill", cache_len=max_seq)
    tc = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jc), "cpu")
    step = _tokens((b,), 9)
    pos = np.arange(b, dtype=np.int32) % 3 + plen - 2    # ragged positions

    def one(c1, t, p):
        lg, c1 = jregistry.forward(
            jcfg, jp, {"tokens": t[None, None]}, mode="decode",
            cache=jax.tree.map(lambda a: a[:, None], c1), pos=p)
        return lg[0, -1], jax.tree.map(lambda a: a[:, 0], c1)

    gold, _ = jax.vmap(one, in_axes=(1, 0, 0))(
        jc, jnp.asarray(step), jnp.asarray(pos))
    args = dict(mode="decode", pos=torch.from_numpy(pos))
    tc2 = tparams.tree_map(lambda _, a: a.clone(), tc)
    got, _ = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(
        step[:, None]).long()}, cache=tc, row_capacity=True, **args)
    assert _diff(got[:, -1], gold) <= LOGIT_TOL
    shared, _ = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(
        step[:, None]).long()}, cache=tc2, **args)
    assert float((shared - got).abs().max()) > 1e-2


def test_row_capacity_batcher_equals_each_row_alone(model):
    """Through the dense-slot batcher: 12 requests of one bucket on 12
    slots give each request's tokens served alone on one slot, at a
    capacity factor where a shared step would drop."""
    _, tcfg, _, tp = model
    cfg = dataclasses.replace(tcfg, capacity_factor=0.05)
    prompts = [_tokens((12,), 20 + i) for i in range(12)]
    max_news = [3 + i % 5 for i in range(12)]
    got, _ = _run(cfg, tp, prompts, max_news, n_slots=12, max_seq=32)
    for p, mn, g in zip(prompts, max_news, got):
        alone, _ = _run(cfg, tp, [p], [mn], n_slots=1, max_seq=32)
        assert g == alone[0]


def test_train_logits_match(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens((2, 12), 0)
    gold = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == gold.shape
    assert _diff(got, gold) <= LOGIT_TOL


def test_prefill_then_decode_logits_match(model):
    jcfg, tcfg, jp, tp = model
    max_seq, plen = 24, 11
    tok = _tokens((2, plen), 1)
    last = np.asarray([plen - 1, plen - 3], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=max_seq,
                               last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp,
                               {"tokens": torch.from_numpy(tok).long()},
                               mode="prefill", cache_len=max_seq,
                               last_pos=torch.from_numpy(last))
    assert _diff(tl, jl) <= LOGIT_TOL
    for leaf in ("k", "v"):
        assert tuple(tc[leaf].shape) == jc[leaf].shape
        assert _diff(tc[leaf], jc[leaf]) <= CACHE_TOL
    for i, step in enumerate(_tokens((4, 2), 2)):
        jl, jc = jregistry.forward(jcfg, jp,
                                   {"tokens": jnp.asarray(step[:, None])},
                                   mode="decode", cache=jc,
                                   pos=jnp.int32(plen + i))
        tl, tc = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(
            step[:, None]).long()}, mode="decode", cache=tc, pos=plen + i)
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"
    for leaf in ("k", "v"):
        assert _diff(tc[leaf], jc[leaf]) <= CACHE_TOL


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=48, **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [drain(r) for r in reqs], bat
