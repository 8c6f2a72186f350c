"""Port parity: dense-slot serving and its decode kernel (B3).

* Kernel twin: ``flash_attention_decode_plain`` (what the CUDA kernel
  ``csrc/flash_decode.cu`` is held against on the card) vs the JAX Pallas
  kernel ``flash_attention_decode`` in interpret mode, over GQA shapes, a
  band window, the ring layout and per-row positions, as
  ``tests/test_serve_fastpath.py`` exercises it.  float32 to 1e-5 (fp32
  summation order); bf16 to one bf16 ulp of the output (both compute in
  fp32 and round once, so they may round to neighbouring values).
* Across frameworks: the port's dense-slot ``ContinuousBatcher`` streams
  the JAX dense-slot batcher's tokens on bridged weights, with
  ``decode_flash`` off and on, for a bf16 cache, ``sliding_window=16``
  (the ring) and an int8 cache.
* Inside the port: bucketed admission == unbucketed greedy, for windowed
  configs too; int8 paged == int8 dense-slot with a pool small enough to
  force preemption; int8 greedy == bf16 greedy at smoke scale.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.kernels.flash_attention import (
    flash_attention_decode as jax_decode)
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.kernels.flash_attention import (
    flash_attention_decode, flash_attention_decode_plain)
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.serve_loop import greedy_generate

torch.set_num_threads(2)

TOL_F32 = 1e-5


# --- kernel twin vs the JAX Pallas kernel ---------------------------------------------

# (hq, hkv, S, window, ring, per-row positions)
KERNEL_CASES = {
    "gqa-8-2": (8, 2, 96, None, False, [95, 17, 0]),
    "mha-4-4": (4, 4, 96, None, False, [40, 95, 63]),
    "mqa-8-1": (8, 1, 96, None, False, [17, 1, 80]),
    "band-24": (8, 2, 80, 24, False, [79, 10, 30]),
    "ring-32": (8, 2, 32, 32, True, [10, 50, 31]),
}


def _kernel_inputs(name, dtype):
    hq, hkv, S, window, ring, pos = KERNEL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    b, d = len(pos), 32
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, 1, d), (b, hkv, S, d), (b, hkv, S, d))]
    jx = [jnp.asarray(a) if dtype == "float32"
          else jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    tx = [tparams.params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]
          for a in jx]
    return jx, tx, np.asarray(pos, np.int32), window, ring


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_plain_matches_jax_pallas_kernel(name, dtype):
    jx, tx, pos, window, ring = _kernel_inputs(name, dtype)
    gold = np.asarray(jax_decode(*jx, jnp.asarray(pos), window=window,
                                 ring=ring, block_k=32, interpret=True),
                      np.float32)
    got = flash_attention_decode_plain(*tx, torch.from_numpy(pos),
                                       window=window, ring=ring)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    err = np.abs(got.float().numpy() - gold)
    if dtype == "float32":
        assert err.max() <= TOL_F32
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(gold), 1e-30)))
                      - 7)
        assert np.all(err <= ulp)
    # the CPU wrapper is the plain version, and launches nothing.
    before = flash_attention_decode.launches
    wrapped = flash_attention_decode(*tx, torch.from_numpy(pos),
                                     window=window, ring=ring)
    assert torch.equal(wrapped, got)
    assert flash_attention_decode.launches == before


def test_ring_warmup_masks_unwritten_slots_and_scalar_pos():
    """During warm-up (pos < window) only slots <= pos count; a host int
    position applies to every row."""
    _, tx, _, _, _ = _kernel_inputs("ring-32", "float32")
    q, k, v = tx
    got = flash_attention_decode_plain(q, k, v, 10, window=32, ring=True)
    trimmed = flash_attention_decode_plain(q, k[:, :, :11], v[:, :, :11],
                                           10)
    assert torch.allclose(got, trimmed, atol=TOL_F32, rtol=0)


def test_argument_errors_match_the_reference():
    _, (q, k, v), pos, _, _ = _kernel_inputs("gqa-8-2", "float32")
    p = torch.from_numpy(pos)
    for fn in (flash_attention_decode_plain, flash_attention_decode):
        with pytest.raises(ValueError, match="sq == 1"):
            fn(torch.cat([q, q], dim=2), k, v, p)
        with pytest.raises(ValueError, match="ring layout requires"):
            fn(q, k, v, p, ring=True)
        with pytest.raises(ValueError, match="not a multiple"):
            fn(q[:, :3], k, v, p)


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """No silent fallback: tensors off the CPU launch the kernel or raise;
    meta tensors raise before any launch."""
    _, (q, k, v), pos, _, _ = _kernel_inputs("gqa-8-2", "float32")
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_decode(q.to("meta"), k, v, torch.from_numpy(pos))


# --- the dense-slot batcher -----------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _prompts(plens, vocab=512):
    return [np.random.default_rng(L).integers(0, vocab, L).astype(np.int32)
            for L in plens]


def _run(cfg, params, prompts, max_news, *, n_slots=2, max_seq=32, **kw):
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=60)
    assert not prod.is_alive()
    return [drain(r) for r in reqs], bat


def _run_jax(cfg, params, prompts, max_news, *, n_slots=2, max_seq=32):
    bat = jbatching.ContinuousBatcher(cfg, params, n_slots=n_slots,
                                      max_seq=max_seq)
    reqs = [jbatching.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=60)
    assert not bat.paged
    return [jbatching.drain(r) for r in reqs], bat


# (config fields, prompt lengths, max_seq): the windowed case straddles
# the window and uses buckets larger than it (the mask-aware ring).
BATCHER_CASES = {
    "bf16": ({}, [8, 5, 11], 32),
    "window16": ({"sliding_window": 16}, [5, 21, 40], 64),
    "int8": ({"kv_cache_dtype": "int8"}, [8, 5, 11], 32),
}


@pytest.fixture(scope="module")
def jax_gold(model):
    """The JAX dense-slot batcher's streams per case (decode_flash off:
    the reference's own tests hold its flash path to these)."""
    _, _, jcfg, jp = model
    out = {}
    for name, (kw, plens, max_seq) in BATCHER_CASES.items():
        got, bat = _run_jax(dataclasses.replace(jcfg, **kw), jp,
                            _prompts(plens), [4, 6, 3], max_seq=max_seq)
        out[name] = (got, bat.steps)
    return out


@pytest.mark.parametrize("decode_flash", [False, True])
@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_dense_slot_batcher_matches_jax_batcher(model, jax_gold, case,
                                                decode_flash):
    cfg, tp, _, _ = model
    kw, plens, max_seq = BATCHER_CASES[case]
    c = dataclasses.replace(cfg, decode_flash=decode_flash, **kw)
    got, bat = _run(c, tp, _prompts(plens), [4, 6, 3], max_seq=max_seq)
    gold, steps = jax_gold[case]
    assert not bat.paged and bat.stats()["paged"] is False
    assert got == gold
    assert bat.steps == steps


def test_bucketed_prefill_equivalence(model):
    """Right-padded bucketed admission gives the unbucketed greedy
    tokens for every prompt length, windowed (ring) caches included."""
    cfg, tp, _, _ = model
    for window, plens, max_seq in ((None, (3, 5, 8, 11), 32),
                                   (16, (5, 16, 21, 40), 64)):
        c = dataclasses.replace(cfg, sliding_window=window,
                                decode_flash=True)
        prompts = _prompts(plens)
        gold = [list(greedy_generate(c, tp, {"tokens": p[None]}, steps=4,
                                     max_seq=max_seq, device="cpu")[0])
                for p in prompts]
        got, bat = _run(c, tp, prompts, [4] * len(plens), n_slots=1,
                        max_seq=max_seq)
        assert got == gold, f"window={window}"
        assert bat.retired == len(plens)


def test_bucket_sizes(model):
    cfg, tp, _, _ = model
    bat = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=48, device="cpu")
    assert [bat._bucket_for(n) for n in (1, 8, 9, 17, 33, 47)] == \
        [8, 8, 16, 32, 48, 48]


def test_int8_paged_matches_int8_dense_slot_with_preemption(model):
    """Inside the port: the int8 paged batcher (B1's int8 branch + B2)
    streams the int8 dense-slot batcher's tokens (B3 + B2), also with a
    5-page pool that forces preemption and resume."""
    cfg, tp, _, _ = model
    c = dataclasses.replace(cfg, kv_cache_dtype="int8", decode_flash=True)
    prompts, max_news = _prompts([5, 11, 19]), [14, 12, 10]
    dense, _ = _run(c, tp, prompts, max_news, n_slots=3, max_seq=48)
    paged_cfg = dataclasses.replace(c, kv_page_size=8)
    got, _ = _run(paged_cfg, tp, prompts, max_news, n_slots=3, max_seq=48,
                  prefill_chunk=32)
    assert got == dense
    got, bat = _run(paged_cfg, tp, prompts, max_news, n_slots=3,
                    max_seq=48, prefill_chunk=32, n_pages=5)
    assert bat.paged and bat.preemptions > 0 and bat.resumes > 0
    assert got == dense
    assert bat.total_used_pages() == 0


def test_int8_kv_greedy_exact():
    """int8 KV must not change greedy decode at smoke scale (per-row
    scales keep the relative error near 1/254), as the reference's
    ``test_int8_kv_greedy_exact`` holds on the same config."""
    cfg = tsmoke(tconfigs.get("qwen1p5-32b"))
    params = tregistry.init(cfg, 0, device="cpu")
    prompt = {"tokens": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    g1 = greedy_generate(cfg, params, prompt, steps=5, max_seq=24,
                         device="cpu")
    g2 = greedy_generate(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                         params, prompt, steps=5, max_seq=24, device="cpu")
    np.testing.assert_array_equal(g1, g2)


def test_families_without_a_forward_still_raise(model):
    """paligemma (vlm) and musicgen (audio) run ``forward`` and generate
    through ``greedy_generate`` (``tests/test_torch_paligemma.py``,
    ``tests/test_torch_musicgen.py``), but the batcher refuses them,
    paged or in dense slots, with the reference's message, as the JAX
    batcher does: its requests carry no image patches or conditioning.
    The moe family constructs both ways (deepseek's latent pages,
    phi3.5's flat pages); the recurrent families
    (``tests/test_torch_recurrent.py``) and gemma3
    (``tests/test_torch_gemma3.py``) serve."""
    for arch, page in (("paligemma-3b", 8), ("musicgen-medium", 0),
                       ("paligemma-3b", 0), ("musicgen-medium", 8)):
        cfg = tsmoke(tconfigs.get(arch))
        with pytest.raises(NotImplementedError,
                           match="^batcher demo covers LM families$"):
            ContinuousBatcher(dataclasses.replace(cfg, kv_page_size=page),
                              {}, n_slots=2, max_seq=32, device="cpu")
        jcfg = dataclasses.replace(jsmoke(jconfigs.get(arch)),
                                   kv_page_size=page)
        with pytest.raises(NotImplementedError,
                           match="^batcher demo covers LM families$"):
            jbatching.ContinuousBatcher(jcfg, {}, n_slots=2, max_seq=32)
    for arch in ("deepseek-v2-lite-16b", "phi3p5-moe-42b"):
        cfg = tsmoke(tconfigs.get(arch))
        params = tregistry.init(cfg, 0, device="cpu")
        for page in (8, 0):
            bat = ContinuousBatcher(
                dataclasses.replace(cfg, kv_page_size=page), params,
                n_slots=2, max_seq=32, device="cpu")
            assert bat.paged == bool(page)