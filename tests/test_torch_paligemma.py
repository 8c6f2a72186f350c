"""Port parity: paligemma-3b (the vlm family) at smoke width, fp32.

The same weights (JAX's ``registry.init(cfg, 0)`` carried across with
``params_from_numpy``) and the same inputs (JAX's ``registry.make_batch``:
``vision_patches`` bf16 patch embeddings put before the text tokens, both
bridged through numpy) go through both packages: train and prefill
logits to ``LOGIT_TOL``, the prefill caches to one bf16 ulp (and the
first layer's in bf16 compute), greedy tokens exactly with
``decode_flash`` off and on (the JAX B3 in interpret mode), decode equal
to the teacher-forced argmax with the patches counted in the positions,
the parameter count and the bridge on ``vis_proj``.  The batcher's refusal of the family is in
``tests/test_torch_dense_slot.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

ARCH = "paligemma-3b"
# as tests/test_torch_moe.py: fp32 logits read through bf16 caches whose
# elements may round to the neighbouring value across frameworks.
LOGIT_TOL = 1e-3
CACHE_ULPS = 1               # bf16 ulps of the element (at least 1.0)


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
    """A JAX batch on the port's side: bf16 patches bit for bit, tokens
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


def test_num_params_and_bridge(model):
    """Both packages count the same parameters (smoke and full width:
    3.04 B); ``vis_proj`` crosses the bridge bit for bit, fp32 and
    bf16."""
    jcfg, tcfg, jp, tp = model
    assert tregistry.num_params(tcfg) == jregistry.num_params(jcfg)
    full = jregistry.num_params(jconfigs.get(ARCH))
    assert tregistry.num_params(tconfigs.get(ARCH)) == full
    assert 3.0e9 < full < 3.1e9
    assert tuple(tp["vis_proj"].shape) == (jcfg.vision_dim, jcfg.d_model)
    np.testing.assert_array_equal(tp["vis_proj"].numpy(),
                                  np.asarray(jp["vis_proj"]))
    j16 = jp["vis_proj"].astype(jnp.bfloat16)
    t16 = tparams.params_from_numpy({"w": np.asarray(j16)}, "cpu")["w"]
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(t16.float().numpy(),
                                  np.asarray(j16.astype(jnp.float32)))


@pytest.mark.parametrize("seq", [12, 20])
def test_train_logits_match_jax(model, seq):
    """Logits at every position, the ``vision_patches`` patch positions
    included: (b, patches + text, Vp)."""
    jcfg, tcfg, jp, tp = model
    batch = jregistry.make_batch(jcfg, "train", 2, seq, seed=seq)
    want = np.asarray(jregistry.forward(jcfg, jp, batch, mode="train"))
    got = tregistry.forward(tcfg, tp, _torch(batch), mode="train")
    assert got.shape == want.shape == (2, seq, tcfg.padded_vocab)
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL


def test_prefill_logits_and_caches_match_jax(model):
    """A right-padded prompt (true lengths 20 and 15 of 20 positions,
    8 of them patches) into a 32-slot cache: last-position logits to
    ``LOGIT_TOL``, the bf16 K/V to one bf16 ulp."""
    jcfg, tcfg, jp, tp = model
    batch = jregistry.make_batch(jcfg, "prefill", 2, 20, seed=5)
    last = np.asarray([19, 14], np.int32)
    jl, jc = jregistry.forward(jcfg, jp, batch, mode="prefill",
                               cache_len=32, last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp, _torch(batch), mode="prefill",
                               cache_len=32, last_pos=torch.from_numpy(last))
    assert tl.shape == jl.shape == (2, 1, tcfg.padded_vocab)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) <= LOGIT_TOL
    assert set(tc) == set(jc) == {"k", "v"}
    for leaf in ("k", "v"):
        assert tc[leaf].dtype == torch.bfloat16
        assert tuple(tc[leaf].shape) == jc[leaf].shape == (2, 2, 1, 32, 32)
        assert _ulps(tc[leaf], jc[leaf]) <= CACHE_ULPS, leaf


def test_bf16_first_layer_caches_match_jax(model):
    """In bf16 compute the first layer's K/V (the projected patches and
    the scaled text embeddings joined in fp32 and rounded once, one norm
    and one projection) stay within one bf16 ulp of the reference's;
    deeper layers add a matmul's rounding per layer, which the fp32 case
    above holds instead."""
    jcfg, tcfg, jp, _ = model
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp16 = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp16), "cpu")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    batch = jregistry.make_batch(jcfg, "prefill", 2, 20, seed=6)
    _, jc = jregistry.forward(jcfg, jp16, batch, mode="prefill",
                              cache_len=32)
    _, tc = tregistry.forward(tcfg, tp16, _torch(batch), mode="prefill",
                              cache_len=32)
    for leaf in ("k", "v"):
        assert _ulps(tc[leaf][0], jc[leaf][0]) <= CACHE_ULPS, leaf


@pytest.mark.parametrize("decode_flash", [False, True])
def test_greedy_tokens_match_jax(model, decode_flash):
    """Patches plus 5 and 11 text tokens, 6 steps: the port's tokens equal
    the reference's exactly, decode through B3's twin and through the
    JAX B3 in interpret mode when ``decode_flash`` is on."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, decode_flash=decode_flash)
    tcfg = dataclasses.replace(tcfg, decode_flash=decode_flash)
    for text in (5, 11):
        prompt = jregistry.make_batch(jcfg, "prefill", 2,
                                      jcfg.vision_patches + text, seed=text)
        want = np.asarray(jgreedy(jcfg, jp, prompt, steps=6, max_seq=32))
        got = tgreedy(tcfg, tp, _numpy(prompt), steps=6, max_seq=32,
                      device="cpu")
        assert got.dtype == np.int32 and got.shape == (2, 6)
        np.testing.assert_array_equal(got, want, err_msg=f"text={text}")


def test_decode_matches_teacher_forced(model):
    """The port's twin of ``tests/test_models.py::
    test_decode_matches_teacher_forced``: prefill + greedy decode equals
    the argmax of the train forward over prompt + generated tokens, at
    positions offset by the patches."""
    _, tcfg, _, tp = model
    steps, text = 4, 8
    prompt = _numpy(jregistry.make_batch(
        jsmoke(jconfigs.get(ARCH)), "prefill", 1,
        tcfg.vision_patches + text, seed=3))
    gen = tgreedy(tcfg, tp, prompt, steps=steps, max_seq=text + steps + 10,
                  device="cpu")
    batch = _torch(dict(prompt, tokens=np.concatenate(
        [prompt["tokens"], gen], axis=1)))
    logits = tregistry.forward(tcfg, tp, batch, mode="train")
    for i in range(steps):
        pos = tcfg.vision_patches + text - 1 + i
        assert int(torch.argmax(logits[0, pos])) == gen[0, i], i
