"""Port parity: phi3.5-moe (smoke width, fp32) on pages and in the batcher.

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``): paged chunk, decode and verify logits to
``LOGIT_TOL`` with pools to one bf16 ulp, with and without
``decode_flash`` (the JAX Pallas kernel in interpret mode against B1's
twin); and the port's batcher streaming the JAX batcher's tokens,
paged, dense and int8, with paged == dense.  The layer's parity is in
``tests/test_torch_moe.py``.
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

torch.set_num_threads(2)

ARCH = "phi3p5-moe-42b"
LOGIT_TOL = 1e-3             # as tests/test_torch_moe.py
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2


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


def _both(cfg_j, cfg_t, **kw):
    return (dataclasses.replace(cfg_j, **kw),
            dataclasses.replace(cfg_t, **kw))


@pytest.mark.parametrize("decode_flash", [False, True])
def test_paged_chunk_decode_verify_logits_match(model, decode_flash):
    """Two sequences prefilled in two chunks (ragged last chunk) into
    shared pools, two decode steps, then a verify span of 4 — with
    ``decode_flash`` through the JAX Pallas kernel (interpret) and the
    port's B1 twin.  Pools to one bf16 ulp."""
    jcfg, tcfg, jp, tp = model
    page, n_pages = 8, 10
    jcfg, tcfg = _both(jcfg, tcfg, kv_page_size=page,
                       decode_flash=decode_flash)
    jpools = jparams.init_params(jregistry.paged_cache_decls(jcfg, n_pages,
                                                             page))
    tpools = tparams.init_params(tregistry.paged_cache_decls(
        tcfg, n_pages, page), device="cpu")
    bt = np.asarray([[7, 2, 9, n_pages], [0, 5, 3, 8]], np.int32)
    jbt, tbt = {"kv": jnp.asarray(bt)}, {"kv": torch.from_numpy(bt)}
    for c, (pos0, last) in enumerate([(np.asarray([0, 0]),
                                       np.asarray([7, 7])),
                                      (np.asarray([8, 8]),
                                       np.asarray([7, 4]))]):
        tok = _tokens((2, 8), 10 + c)
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(tok)}, mode="chunk",
            cache={"pages": jpools, "block_tab": jbt},
            pos=jnp.asarray(pos0, jnp.int32),
            last_pos=jnp.asarray(last, jnp.int32),
            cache_offset=jnp.zeros((2,), jnp.int32))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="chunk",
            cache={"pages": tpools, "block_tab": tbt},
            pos=torch.from_numpy(pos0).int(),
            last_pos=torch.from_numpy(last).int(),
            cache_offset=torch.zeros(2, dtype=torch.int32))
        assert _diff(tl, jl) <= LOGIT_TOL, f"chunk {c}"
    pos = np.asarray([16, 13], np.int32)
    for i, step in enumerate(_tokens((2, 2), 20)):
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(step[:, None])}, mode="decode",
            cache={"pages": jpools, "block_tab": jbt},
            pos=jnp.asarray(pos + i))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
            mode="decode", cache={"pages": tpools, "block_tab": tbt},
            pos=torch.from_numpy(pos + i))
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"
    span = _tokens((2, 4), 21)
    jl, jpools = jregistry.forward(
        jcfg, jp, {"tokens": jnp.asarray(span)}, mode="verify",
        cache={"pages": jpools, "block_tab": jbt}, pos=jnp.asarray(pos + 2))
    tl, tpools = tregistry.forward(
        tcfg, tp, {"tokens": torch.from_numpy(span).long()}, mode="verify",
        cache={"pages": tpools, "block_tab": tbt},
        pos=torch.from_numpy(pos + 2))
    assert tl.shape == (2, 4, tcfg.padded_vocab)
    assert _diff(tl, jl) <= LOGIT_TOL
    for leaf in ("k", "v"):
        assert _diff(tpools["kv"][leaf], jpools["kv"][leaf]) <= CACHE_TOL


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


def _jrun(cfg, params, prompts, max_news, **kw):
    bat = jbatching.ContinuousBatcher(cfg, params, **kw)
    reqs = [jbatching.Request(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [jbatching.drain(r) for r in reqs]


@pytest.mark.parametrize("extra", [
    {"kv_page_size": 8},
    {},                                               # dense slots
    {"kv_page_size": 8, "kv_cache_dtype": "int8"},
    {"kv_cache_dtype": "int8"},
])
def test_batcher_matches_jax_batcher(model, extra):
    """Mirror of tests/test_paged_kv.py::
    test_paged_matches_dense_across_families[phi3p5-moe-42b-None]: the
    port's batcher streams the JAX batcher's tokens, paged (two prompt
    chunks for the longest), dense and int8; and paged == dense."""
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = _both(jcfg, tcfg, **extra)
    prompts = [_tokens((n,), 30 + n) for n in (5, 12, 21)]
    max_news = [4, 3, 4]
    gold = _jrun(jcfg, jp, prompts, max_news, n_slots=2, max_seq=48)
    got, bat = _run(tcfg, tp, prompts, max_news, max_seq=48)
    assert bat.paged == ("kv_page_size" in extra)
    assert got == gold
    if bat.paged:
        dense, _ = _run(dataclasses.replace(tcfg, kv_page_size=0), tp,
                        prompts, max_news, max_seq=48)
        assert got == dense
        assert bat.total_used_pages() == 0
