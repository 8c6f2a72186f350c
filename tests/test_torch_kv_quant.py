"""Port parity: int8 KV quantize / dequantize (kernel B2) and the int8 caches.

The port's plain twins ``kv_quantize_plain`` / ``kv_dequantize_plain``
(what the CUDA kernels are held against, bit for bit, on the card) must
be BIT-EQUAL to the reference's model-path functions
``repro.models.layers._kv_quantize`` / ``_kv_dequantize`` and to the JAX
Pallas kernels ``repro.kernels.kv_quant.kv_quantize`` / ``kv_dequantize``
in interpret mode.  One measured exception, in the reference itself: for
bf16 inputs the Pallas kernel under interpret mode on the CPU is not an
IEEE division; it differs from ``_kv_quantize`` by one int8 step where
the exact fp32 quotient lies within 1e-5 of a .5 tie.  The port follows
``_kv_quantize`` (the function every int8 path of the reference runs);
that case is asserted as exactly what it is.

Also: the int8 cache declarations, spill/restore of int8 pools with
their scale pages, and an int8 prefill + decode against the JAX package
on bridged weights (logits to ``LOGIT_TOL``; int8 caches equal but for
one step at near-ties, as the fp32 K/V the two frameworks quantize may
differ in their last bits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.kernels import kv_quant as jkq
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_plain,
                                          kv_quantize, kv_quantize_plain)
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.batching import ContinuousBatcher

torch.set_num_threads(2)

# logits read through int8 caches: the two frameworks' fp32 K/V may
# differ in the last bits before quantization and land on a neighbouring
# int8 step at a near-tie, so logits are held as in test_torch_model.py.
LOGIT_TOL = 1e-3
# the Pallas interpret divergence stays this close to a .5 tie.
TIE_TOL = 1e-5


def _rows(seed, rows, d=32):
    """Rows of widely varying scale, an all-zero row, and a row of exact
    .5 quotients (amax 127 gives scale 1.0 exactly)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d))
         * rng.uniform(0.01, 10.0, (rows, 1))).astype(np.float32)
    x[1] = 0.0
    x[2, :8] = [2.5, -3.5, 0.5, 1.5, -0.5, 127.0, 4.5, -126.5]
    return x


def _jax_in(x, dtype):
    jx = jnp.asarray(x)
    return jx if dtype == "float32" else jx.astype(jnp.bfloat16)


def _torch_in(jx):
    """The same values (bf16 carried by bits) as a torch tensor."""
    return tparams.params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("rows", [7, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_bit_equal_to_reference(dtype, rows):
    jx = _jax_in(_rows(rows, rows), dtype)
    tq, ts = kv_quantize_plain(_torch_in(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (rows, 1)
    gq, gs = jlayers._kv_quantize(jx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(gq))
    np.testing.assert_array_equal(_np(ts), np.asarray(gs, np.float32))
    # round half to even, as jnp.round: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0.
    assert tq[2, :8].tolist() == [2, -4, 0, 2, 0, 127, 4, -126]
    assert torch.count_nonzero(tq[1]) == 0

    pq, ps = jkq.kv_quantize(jx, interpret=True)
    pq = np.asarray(pq)
    np.testing.assert_array_equal(_np(ts), np.asarray(ps, np.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(tq.numpy(), pq)
    else:
        off = tq.numpy() != pq
        xf = _np(_torch_in(jx))
        quo = xf / ts.float().numpy()
        frac = np.abs(np.abs(quo) - np.floor(np.abs(quo)) - 0.5)
        assert np.all(np.abs(tq.numpy()[off].astype(int) - pq[off]) == 1)
        assert np.all(frac[off] < TIE_TOL)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequantize_plain_bit_equal_to_reference(out):
    jx = _jax_in(_rows(3, 300), "float32")
    q, s = jlayers._kv_quantize(jx)
    jdt = jnp.float32 if out == "float32" else jnp.bfloat16
    tdt = torch.float32 if out == "float32" else torch.bfloat16
    got = kv_dequantize_plain(torch.from_numpy(np.array(q)),
                              _torch_in(s), tdt)
    assert got.dtype == tdt
    for gold in (jlayers._kv_dequantize(q, s, jdt),
                 jkq.kv_dequantize(q, s, jdt, interpret=True)):
        np.testing.assert_array_equal(_np(got), np.asarray(gold, np.float32))


def test_wrappers_run_the_plain_twins_on_the_cpu_and_launch_nothing():
    x = torch.from_numpy(_rows(4, 40)).bfloat16()
    before = (kv_quantize.launches, kv_dequantize.launches)
    q, s = kv_quantize(x)
    pq, ps = kv_quantize_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(kv_dequantize(q, s, torch.float32),
                       kv_dequantize_plain(q, s, torch.float32))
    assert (kv_quantize.launches, kv_dequantize.launches) == before


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel or raises — here (meta tensors) it raises before any launch."""
    x = torch.zeros((4, 32)).to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        kv_quantize(x)
    q = torch.zeros((4, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="one CUDA device"):
        kv_dequantize(q, torch.zeros((4, 1)).bfloat16().to("meta"))


def test_layer_helpers_keep_leading_axes():
    """``layers._kv_quantize`` flattens (..., hd) to rows for B2 and
    restores the shape; scales get a trailing 1."""
    x = torch.from_numpy(_rows(5, 24).reshape(2, 3, 4, 32))
    q, s = tlayers._kv_quantize(x)
    assert q.shape == x.shape and tuple(s.shape) == (2, 3, 4, 1)
    fq, fs = kv_quantize_plain(x.reshape(-1, 32))
    assert torch.equal(q.reshape(-1, 32), fq)
    assert torch.equal(s.reshape(-1, 1), fs)
    back = tlayers._kv_dequantize(q, s, torch.float32)
    assert torch.equal(back, kv_dequantize_plain(fq, fs, torch.float32)
                       .reshape(x.shape))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jsmoke(jconfigs.get("minitron-4b")),
                               kv_cache_dtype="int8")
    tcfg = dataclasses.replace(tsmoke(tconfigs.get("minitron-4b")),
                               kv_cache_dtype="int8")
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_int8_cache_decls_match_reference(model):
    jcfg, tcfg, _, _ = model
    jd = jregistry.cache_decls(jcfg, 2, 24)
    td = tregistry.cache_decls(tcfg, 2, 24)
    jpd = jregistry.paged_cache_decls(jcfg, 5, 8)["kv"]
    tpd = tregistry.paged_cache_decls(tcfg, 5, 8)["kv"]
    for j, t in ((jd, td), (jpd, tpd)):
        assert set(t) == {"k", "v", "k_scale", "v_scale"} == set(j)
        for leaf in t:
            assert t[leaf].shape == j[leaf].shape
        assert t["k"].dtype == torch.int8
        assert t["k_scale"].dtype == torch.bfloat16


def test_int8_prefill_and_decode_match_jax(model):
    """int8 dense prefill then decode steps (the reference's dense decode
    takes one position for the batch; the port's gets it as a (b,)
    tensor): logits to LOGIT_TOL, and the int8 caches equal the
    reference's except at near-ties (one int8 step), scales to one bf16
    ulp."""
    jcfg, tcfg, jp, tp = model
    max_seq, plen = 24, 11
    tok = np.random.default_rng(1).integers(0, 512, (2, plen)).astype(
        np.int32)
    last = np.asarray([plen - 1, plen - 3], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=max_seq,
                               last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp,
                               {"tokens": torch.from_numpy(tok).long()},
                               mode="prefill", cache_len=max_seq,
                               last_pos=torch.from_numpy(last))
    assert set(tc) == {"k", "v", "k_scale", "v_scale"}
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_TOL
    for i, step in enumerate(np.random.default_rng(2).integers(
            0, 512, (3, 2))):
        jl, jc = jregistry.forward(jcfg, jp,
                                   {"tokens": jnp.asarray(step[:, None])},
                                   mode="decode", cache=jc,
                                   pos=jnp.int32(plen + i))
        tl, tc = tregistry.forward(
            tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
            mode="decode", cache=tc,
            pos=torch.full((2,), plen + i, dtype=torch.int32))
        assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) \
            <= LOGIT_TOL, f"decode step {i}"
    for leaf in ("k", "v"):
        diff = np.abs(tc[leaf].numpy().astype(int) - np.asarray(jc[leaf]))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        sdiff = np.abs(_np(tc[leaf + "_scale"])
                       - np.asarray(jc[leaf + "_scale"], np.float32))
        assert np.all(sdiff <= 2.0 ** -8 * np.abs(_np(tc[leaf + "_scale"])))


def test_int8_decode_from_one_prefill_cache_matches_jax(model):
    """int8 decode steps of both frameworks from the same cache (the
    port's int8 prefill cache, carried to JAX bit for bit): logits to
    LOGIT_TOL at every step, and the caches the steps write equal but for
    one int8 step at near-ties, scales to one bf16 ulp.  Beside the
    prefill-to-decode chain above, which a near-tie of the two prefills
    can move by about one int8 step, this holds the decode step alone
    over several prompts."""
    jcfg, tcfg, jp, tp = model
    max_seq, plen = 24, 11
    for seed in range(3):
        tok = np.random.default_rng(10 + seed).integers(
            0, 512, (2, plen)).astype(np.int32)
        _, tc = tregistry.forward(tcfg, tp,
                                  {"tokens": torch.from_numpy(tok).long()},
                                  mode="prefill", cache_len=max_seq)
        jc = {n: jnp.asarray(_np(t)).astype(
            jnp.int8 if t.dtype == torch.int8 else jnp.bfloat16)
            for n, t in tc.items()}
        for i, step in enumerate(np.random.default_rng(20 + seed).integers(
                0, 512, (3, 2))):
            jl, jc = jregistry.forward(
                jcfg, jp, {"tokens": jnp.asarray(step[:, None])},
                mode="decode", cache=jc, pos=jnp.int32(plen + i))
            tl, tc = tregistry.forward(
                tcfg, tp, {"tokens": torch.from_numpy(step[:, None]).long()},
                mode="decode", cache=tc,
                pos=torch.full((2,), plen + i, dtype=torch.int32))
            assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) \
                <= LOGIT_TOL, f"prompt {seed}, decode step {i}"
        for leaf in ("k", "v"):
            diff = np.abs(tc[leaf].numpy().astype(int)
                          - np.asarray(jc[leaf]))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            sdiff = np.abs(_np(tc[leaf + "_scale"])
                           - np.asarray(jc[leaf + "_scale"], np.float32))
            assert np.all(sdiff <= 2.0 ** -8
                          * np.abs(_np(tc[leaf + "_scale"])))


def test_int8_pool_spill_restore_bit_identical(model):
    """Preemption parks int8 pages AND their scale pages on the host and
    restores them bit for bit, dtypes kept."""
    _, tcfg, _, tp = model
    bat = ContinuousBatcher(dataclasses.replace(tcfg, kv_page_size=8), tp,
                            n_slots=2, max_seq=32, device="cpu")
    pools = bat.pools
    assert set(pools["kv"]) == {"k", "v", "k_scale", "v_scale"}
    g = torch.Generator().manual_seed(0)
    for name, leaf in pools["kv"].items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=g).bfloat16())
    data = bat.layout.spill(pools, "kv", [1, 3])
    assert data["k"].dtype == torch.int8
    assert data["k_scale"].dtype == torch.bfloat16
    bat.layout.restore(pools, "kv", data, [5, 0])
    for name, leaf in pools["kv"].items():
        assert torch.equal(leaf[:, 5], leaf[:, 1]), name
        assert torch.equal(leaf[:, 0], leaf[:, 3]), name
    with pytest.raises(TypeError, match="dtype"):
        bat.layout.restore(pools, "kv", {k: v.float()
                                         for k, v in data.items()}, [2, 4])
