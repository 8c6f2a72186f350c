"""Port parity: the two dense archs no other port test holds to JAX.

granite-34b (MQA, one kv head; ungated GELU MLP) and qwen1.5-32b
(``qkv_bias``) at smoke width, fp32, on JAX's weights
(``registry.init(cfg, 0)`` carried across with ``params_from_numpy``):
train logits within ``LOGIT_TOL``, six greedy tokens and the dense and
paged batchers' tokens equal to the JAX package's.
"""

import threading

import jax.numpy as jnp
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
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
ARCHS = ["granite-34b", "qwen1p5-32b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jsmoke(jconfigs.get(request.param))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tsmoke(tconfigs.get(request.param)), jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_config_features(model):
    _, tcfg, _, tp = model
    attn = tp["blocks"]["attn"]
    if tcfg.name.startswith("granite"):
        assert tcfg.n_kv_heads == 1 and not tcfg.mlp_gated
        assert "w_gate" not in tp["blocks"]["mlp"]
    else:
        assert tcfg.qkv_bias and ("bq" in attn or "bqkv" in attn)


def test_train_logits_match(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens((2, 12), 0)
    gold = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == gold.shape
    err = float(np.abs(got.numpy() - np.asarray(gold)).max())
    assert err <= LOGIT_TOL


def test_greedy_tokens_match(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens((2, 9), 1)
    gold = np.asarray(jgreedy(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              steps=6, max_seq=32))
    got = tgreedy(tcfg, tp, {"tokens": tok}, steps=6, max_seq=32,
                  device="cpu")
    np.testing.assert_array_equal(got, gold)


def _serve(bat, prompts, max_news, req, drain_fn):
    reqs = [req(rid=i, prompt=p, max_new=mn)
            for i, (p, mn) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [drain_fn(r) for r in reqs]


@pytest.mark.parametrize("page", [0, 8])
def test_batcher_matches_jax_batcher(model, page):
    jcfg, tcfg, jp, tp = model
    prompts = [_tokens((n,), 40 + n) for n in (5, 12, 21)]
    max_news = [4, 3, 4]
    kw = dict(n_slots=2, max_seq=48, page_size=page or None)
    gold = _serve(jbatching.ContinuousBatcher(jcfg, jp, **kw), prompts,
                  max_news, jbatching.Request, jbatching.drain)
    bat = ContinuousBatcher(tcfg, tp, device="cpu", **kw)
    got = _serve(bat, prompts, max_news, Request, drain)
    assert bat.paged == bool(page)
    assert got == gold
