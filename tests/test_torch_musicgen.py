"""Port parity: musicgen-medium (the audio family) at smoke width, fp32.

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``) and the same inputs (JAX's ``registry.make_batch``:
tokens (b, s, K) over the ``n_codebooks`` codebooks and the bf16
conditioning rows ``cond``, both bridged through numpy) go through both
packages: the codebook embedding summed in bf16 bit for bit, the
cross-attention block alone against the reference's ``cross_apply``,
train and prefill logits (b, s, K, Vp) to ``LOGIT_TOL``, the prefill
caches to one bf16 ulp (and the first layer's in bf16 compute), greedy
(b, steps, K) tokens exactly with ``decode_flash`` off and on (the JAX
B3 in interpret mode), decode equal to the teacher-forced argmax, the
parameter count and the bridge on the ``cross.*`` leaves and the (K, Vp,
d) embed and (K, d, Vp) unembed.  The batcher's refusal of the family is
in ``tests/test_torch_dense_slot.py``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttransformer
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

ARCH = "musicgen-medium"
# as tests/test_torch_moe.py: fp32 logits read through bf16 caches whose
# elements may round to the neighbouring value across frameworks.
LOGIT_TOL = 1e-3
CACHE_ULPS = 1               # bf16 ulps of the element (at least 1.0)
CROSS_TOL = 1e-5             # one cross-attention block, fp32


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get(ARCH))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tsmoke(tconfigs.get(ARCH)), jp, tp


def _numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _torch(batch):
    """A JAX batch on the port's side: bf16 ``cond`` bit for bit, tokens
    as int64 indices."""
    out = tparams.params_from_numpy(_numpy(batch), "cpu")
    out["tokens"] = out["tokens"].long()
    return out


def _ulps(t: torch.Tensor, j) -> float:
    """Largest |t - j| in bf16 ulps of the larger magnitude, at least 1
    (one ulp of a bf16 value x is 2**(floor(log2|x|) - 7))."""
    a = t.float().numpy()
    b = np.asarray(j.astype(jnp.float32))
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(a - b) / ulp).max())


def _bf16(jcfg, tcfg, jp):
    """Both configs in bf16 compute, the JAX weights rounded to bf16 and
    carried across."""
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    return (dataclasses.replace(jcfg, dtype="bfloat16"),
            dataclasses.replace(tcfg, dtype="bfloat16"), jp16,
            tparams.params_from_numpy(
                tparams.tree_map(lambda _, a: np.asarray(a), jp16), "cpu"))


def test_num_params_and_bridge(model):
    """Both packages count the same parameters (smoke and full width:
    1.84 B); the cross-attention leaves, the codebook embed (K, Vp, d)
    and unembed (K, d, Vp) cross the bridge bit for bit, fp32 and bf16."""
    jcfg, tcfg, jp, tp = model
    assert tregistry.num_params(tcfg) == jregistry.num_params(jcfg)
    full = jregistry.num_params(jconfigs.get(ARCH))
    assert tregistry.num_params(tconfigs.get(ARCH)) == full
    assert 1.8e9 < full < 1.9e9
    K, Vp, d = jcfg.n_codebooks, jcfg.padded_vocab, jcfg.d_model
    assert tuple(tp["embed"].shape) == (K, Vp, d)
    assert tuple(tp["unembed"].shape) == (K, d, Vp)
    assert set(tp["blocks"]["cross"]) == {"norm", "wq", "wk", "wv", "wo"}
    leaves = {"embed": jp["embed"], "unembed": jp["unembed"],
              **{f"cross.{k}": v for k, v in jp["blocks"]["cross"].items()}}
    got = {"embed": tp["embed"], "unembed": tp["unembed"],
           **{f"cross.{k}": v for k, v in tp["blocks"]["cross"].items()}}
    t16 = tparams.params_from_numpy(
        {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in leaves.items()},
        "cpu")
    for name, j in leaves.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(j),
                                      err_msg=name)
        assert t16[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t16[name].float().numpy(),
            np.asarray(j.astype(jnp.bfloat16).astype(jnp.float32)),
            err_msg=name)


def test_bf16_embedding_sum_is_bit_equal(model):
    """The four codebooks' embeddings added in codebook order in bf16,
    rounding after every add, equal the reference's bit for bit; a sum
    rounded once would not be."""
    jcfg, tcfg, jp, _ = model
    jcfg, tcfg, jp16, tp16 = _bf16(jcfg, tcfg, jp)
    batch = jregistry.make_batch(jcfg, "prefill", 2, 24, seed=7)
    want = jtransformer._embed_input(jcfg, jp16, batch)
    got = ttransformer._embed_input(tcfg, tp16, _torch(batch))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    tok = _torch(batch)["tokens"]
    once = sum(tp16["embed"][c][tok[..., c]].float()
               for c in range(tcfg.n_codebooks)).to(torch.bfloat16)
    assert not torch.equal(once, got)


def test_cross_attention_block_matches_cross_apply(model):
    """The block alone, layer 1's weights, a 6-position x and a
    one-position x (a decode step's) against the reference's
    ``cross_apply`` (the closure its musicgen layer calls)."""
    jcfg, tcfg, jp, tp = model
    _, apply, _, _ = jtransformer.musicgen_blocks(jcfg)
    cross_apply = inspect.getclosurevars(apply).nonlocals["cross_apply"]
    rng = np.random.default_rng(11)
    cond = rng.standard_normal((2, jcfg.cond_len, jcfg.d_model)).astype(
        np.float32)
    jw = jax.tree.map(lambda a: a[1], jp["blocks"]["cross"])
    tw = tparams.tree_map(lambda _, a: a[1], tp["blocks"]["cross"])
    for s in (6, 1):
        x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
        want = np.asarray(cross_apply(jw, jnp.asarray(x), jnp.asarray(cond)))
        got = tlayers.cross_attention_apply(tcfg, tw, torch.from_numpy(x),
                                            torch.from_numpy(cond))
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= CROSS_TOL, s


@pytest.mark.parametrize("seq", [9, 16])
def test_train_logits_match_jax(model, seq):
    jcfg, tcfg, jp, tp = model
    batch = jregistry.make_batch(jcfg, "train", 2, seq, seed=seq)
    want = np.asarray(jregistry.forward(jcfg, jp, batch, mode="train"))
    got = tregistry.forward(tcfg, tp, _torch(batch), mode="train")
    assert got.shape == want.shape == (2, seq, jcfg.n_codebooks,
                                       tcfg.padded_vocab)
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL


def test_prefill_logits_and_caches_match_jax(model):
    """A right-padded 16-frame prompt (true lengths 16 and 11) into a
    32-slot cache: last-position logits (b, 1, K, Vp) to ``LOGIT_TOL``,
    the bf16 K/V to one bf16 ulp."""
    jcfg, tcfg, jp, tp = model
    batch = jregistry.make_batch(jcfg, "prefill", 2, 16, seed=5)
    last = np.asarray([15, 10], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, batch, mode="prefill",
                               cache_len=32, last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp, _torch(batch), mode="prefill",
                               cache_len=32, last_pos=torch.from_numpy(last))
    assert tl.shape == jl.shape == (2, 1, jcfg.n_codebooks,
                                    tcfg.padded_vocab)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_TOL
    assert set(tc) == set(jc) == {"k", "v"}
    for leaf in ("k", "v"):
        assert tuple(tc[leaf].shape) == jc[leaf].shape == (2, 2, 4, 32, 32)
        assert _ulps(tc[leaf], jc[leaf]) <= CACHE_ULPS, leaf


def test_bf16_first_layer_caches_match_jax(model):
    """In bf16 compute the first layer's K/V (the bf16 codebook sum, one
    norm and one projection) stay within one bf16 ulp of the reference's;
    deeper layers add a matmul's rounding per layer, which the fp32 case
    above holds instead."""
    jcfg, tcfg, jp, _ = model
    jcfg, tcfg, jp16, tp16 = _bf16(jcfg, tcfg, jp)
    batch = jregistry.make_batch(jcfg, "prefill", 2, 16, seed=6)
    _, jc = jregistry.forward(jcfg, jp16, batch, mode="prefill",
                              cache_len=32)
    _, tc = tregistry.forward(tcfg, tp16, _torch(batch), mode="prefill",
                              cache_len=32)
    for leaf in ("k", "v"):
        assert _ulps(tc[leaf][0], jc[leaf][0]) <= CACHE_ULPS, leaf


@pytest.mark.parametrize("decode_flash", [False, True])
def test_greedy_tokens_match_jax(model, decode_flash):
    """Prompts of 3 and 9 frames, 6 steps: (b, 6, K) tokens equal the
    reference's exactly, ``cond`` passed to every decode step, decode
    through B3's twin and through the JAX B3 in interpret mode when
    ``decode_flash`` is on."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, decode_flash=decode_flash)
    tcfg = dataclasses.replace(tcfg, decode_flash=decode_flash)
    for plen in (3, 9):
        prompt = jregistry.make_batch(jcfg, "prefill", 2, plen, seed=plen)
        want = np.asarray(jgreedy(jcfg, jp, prompt, steps=6, max_seq=24))
        got = tgreedy(tcfg, tp, _numpy(prompt), steps=6, max_seq=24,
                      device="cpu")
        assert got.dtype == np.int32
        assert got.shape == (2, 6, jcfg.n_codebooks)
        np.testing.assert_array_equal(got, want, err_msg=f"plen={plen}")


def test_decode_matches_teacher_forced(model):
    """The port's twin of ``tests/test_models.py::
    test_decode_matches_teacher_forced``: prefill + greedy decode equals
    the argmax of the train forward over prompt + generated frames, every
    codebook at every position."""
    jcfg, tcfg, _, tp = model
    steps, plen = 4, 8
    prompt = _numpy(jregistry.make_batch(jcfg, "prefill", 1, plen, seed=3))
    gen = tgreedy(tcfg, tp, prompt, steps=steps, max_seq=plen + steps + 2,
                  device="cpu")
    batch = _torch(dict(prompt, tokens=np.concatenate(
        [prompt["tokens"], gen], axis=1)))
    logits = tregistry.forward(tcfg, tp, batch, mode="train")
    for i in range(steps):
        pred = torch.argmax(logits[0, plen - 1 + i], -1).numpy()
        np.testing.assert_array_equal(pred, gen[0, i], err_msg=str(i))
