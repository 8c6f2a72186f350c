"""Port parity: the dense model on the minitron-4b smoke config.

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``) and the same numpy-made tokens go through both
packages in every forward mode the serving path uses: train, prefill,
dense decode, and paged chunk + decode with ``decode_flash=True`` (the
JAX Pallas kernel in interpret mode against the port's kernel twin).
Both compute in float32, but caches are bf16: a cached element whose
fp32 value differs in the last bits between the frameworks may round to
the neighbouring bf16 value, so caches are held to one bf16 ulp
(``CACHE_TOL``), and logits read through such caches to ``LOGIT_TOL``
absolute (fp32 summation order alone stays below 1e-4; the worst decode
step measured 3.4e-4).  Greedy tokens must be identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import registry as jregistry
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
CACHE_TOL = 2.0 ** -6        # one bf16 ulp at |x| < 2


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    tcfg = tsmoke(tconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _diff(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j.astype(jnp.float32))).max())


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert _diff(got, jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))) < 1e-5
    for pos in (np.arange(5), np.arange(10).reshape(2, 5) + 3):
        p = pos[..., None] if pos.ndim == 2 else pos
        got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(p), 1e4)
        gold = jlayers.rope(jnp.asarray(x), jnp.asarray(p), 1e4)
        assert _diff(got, gold) < 1e-4
    gate, up = rng.standard_normal((2, 2, 3, 8)).astype(np.float32)
    got = tlayers.swiglu(torch.from_numpy(gate), torch.from_numpy(up))
    assert _diff(got, jlayers.swiglu(jnp.asarray(gate), jnp.asarray(up))) \
        < 1e-6


@pytest.mark.parametrize("window", [None, 4])
def test_attention_kernels_match(window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    got = tlayers.attention_xla(*map(torch.from_numpy, (q, k, v)),
                                window=window)
    gold = jlayers.attention_xla(*map(jnp.asarray, (q, k, v)), window=window)
    assert _diff(got, gold) < 1e-5
    mask = rng.random((2, 6, 6)) < 0.7
    mask[..., 0] = True
    got = tlayers.attention_masked(*map(torch.from_numpy, (q, k, v, mask)))
    gold = jlayers.attention_masked(*map(jnp.asarray, (q, k, v, mask)))
    assert _diff(got, gold) < 1e-5


def test_train_logits_match(model):
    jcfg, tcfg, jp, tp = model
    tok = _tokens((2, 12), 0)
    gold = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == gold.shape
    assert _diff(got, gold) <= LOGIT_TOL


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_then_decode_logits_match(model, window):
    """Dense prefill (ring-rolled for a window equal to the cache length)
    then dense decode steps on the same tokens."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
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
        assert tc[leaf].dtype == torch.bfloat16
        assert _diff(tc[leaf], jc[leaf]) <= CACHE_TOL
    steps = _tokens((4, 2), 2)
    for i, step in enumerate(steps):
        pos = plen + i
        jl, jc = jregistry.forward(jcfg, jp,
                                   {"tokens": jnp.asarray(step[:, None])},
                                   mode="decode", cache=jc,
                                   pos=jnp.int32(pos))
        tl, tc = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(
            step[:, None]).long()}, mode="decode", cache=tc, pos=pos)
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"


def test_paged_chunk_and_decode_flash_logits_match(model):
    """Two sequences prefilled in two chunks each (ragged last chunk via
    last_pos) into shared page pools, then decoded through the paged
    decode kernel: the JAX Pallas kernel (interpret) vs the port's."""
    jcfg, tcfg, jp, tp = model
    page, n_pages, nb = 8, 10, 4
    jcfg = dataclasses.replace(jcfg, kv_page_size=page, decode_flash=True)
    tcfg = dataclasses.replace(tcfg, kv_page_size=page, decode_flash=True)
    jpools = jparams.init_params(jregistry.paged_cache_decls(jcfg, n_pages,
                                                             page))
    tpools = tparams.init_params(tregistry.paged_cache_decls(tcfg, n_pages,
                                                             page),
                                 device="cpu")
    bt = np.asarray([[7, 2, 9, n_pages], [0, 5, 3, 8]], np.int32)
    chunks = [(np.asarray([0, 0]), np.asarray([7, 7])),
              (np.asarray([8, 8]), np.asarray([7, 4]))]
    for c, (pos0, last) in enumerate(chunks):
        tok = _tokens((2, 8), 10 + c)
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(tok)}, mode="chunk",
            cache={"pages": jpools, "block_tab": {"kv": jnp.asarray(bt)}},
            pos=jnp.asarray(pos0, jnp.int32),
            last_pos=jnp.asarray(last, jnp.int32),
            cache_offset=jnp.zeros((2,), jnp.int32))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(tok).long()}, mode="chunk",
            cache={"pages": tpools, "block_tab": {"kv": torch.from_numpy(bt)}},
            pos=torch.from_numpy(pos0).int(),
            last_pos=torch.from_numpy(last).int(),
            cache_offset=torch.zeros(2, dtype=torch.int32))
        assert _diff(tl, jl) <= LOGIT_TOL, f"chunk {c}"
    pos = np.asarray([16, 13], np.int32)
    for i, step in enumerate(_tokens((3, 2), 20)):
        jl, jpools = jregistry.forward(
            jcfg, jp, {"tokens": jnp.asarray(step[:, None])}, mode="decode",
            cache={"pages": jpools, "block_tab": {"kv": jnp.asarray(bt)}},
            pos=jnp.asarray(pos + i))
        tl, tpools = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
            mode="decode",
            cache={"pages": tpools, "block_tab": {"kv": torch.from_numpy(bt)}},
            pos=torch.from_numpy(pos + i))
        assert _diff(tl, jl) <= LOGIT_TOL, f"decode step {i}"
    for leaf in ("k", "v"):
        assert _diff(tpools["kv"][leaf], jpools["kv"][leaf]) <= CACHE_TOL


@pytest.mark.parametrize("window,plens", [(None, (3, 9, 14)),
                                          (16, (5, 21, 40))])
def test_greedy_generate_tokens_identical(model, window, plens):
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    for plen in plens:
        tok = _tokens((2, plen), plen)
        gold = np.asarray(jgreedy(jcfg, jp, {"tokens": jnp.asarray(tok)},
                                  steps=6, max_seq=64))
        got = tgreedy(tcfg, tp, {"tokens": tok}, steps=6, max_seq=64,
                      device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, gold, err_msg=f"plen={plen}")


def test_later_slices_raise(model):
    """paligemma (vlm) and musicgen (audio) run ``forward`` and build
    their dense ``cache_decls`` (the dense stack's K/V), but have no page
    layout, as in the reference; verify needs pages; deepseek and phi3.5
    (the moe family) page and run."""
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="verify"):
        tregistry.forward(tcfg, tp, {"tokens": torch.zeros(1, 2).long()},
                          mode="verify")
    for arch, tok, extra, shape in (
            ("paligemma-3b", (1, 2), ("patches", (1, 8, 64)), (1, 10)),
            ("musicgen-medium", (1, 2, 4), ("cond", (1, 8, 128)), (1, 2, 4))):
        cfg = tsmoke(tconfigs.get(arch))
        params = tregistry.init(cfg, 0, device="cpu")
        batch = {"tokens": torch.zeros(tok).long(),
                 extra[0]: torch.randn(extra[1])}
        logits = tregistry.forward(cfg, params, batch)
        assert logits.shape == shape + (cfg.padded_vocab,)
        decls = tregistry.cache_decls(cfg, 2, 16)
        assert {n: d.shape for n, d in decls.items()} == {
            n: (cfg.n_layers, 2, cfg.n_kv_heads, 16, cfg.head_dim)
            for n in ("k", "v")}
        assert not tregistry.paged_supported(cfg)
        with pytest.raises(NotImplementedError, match="paged KV unsupported"):
            tregistry.paged_cache_decls(cfg, 4, 8)
    for arch in ("deepseek-v2-lite-16b", "phi3p5-moe-42b"):
        cfg = tsmoke(tconfigs.get(arch))
        assert tregistry.paged_supported(cfg)
        assert tregistry.paged_cache_decls(cfg, 4, 8)
        params = tregistry.init(cfg, 0, device="cpu")
        logits = tregistry.forward(cfg, params,
                                   {"tokens": torch.zeros(1, 2).long()})
        assert logits.shape == (1, 2, cfg.padded_vocab)
    assert tregistry.paged_supported(tcfg)
    assert tregistry.paged_supported(tsmoke(tconfigs.get("gemma3-12b")))
    assert not tregistry.paged_supported(tsmoke(tconfigs.get("zamba2-1p2b")))
