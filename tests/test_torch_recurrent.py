"""Port parity: the recurrent families, mamba2 (ssm) and zamba2 (hybrid).

Smoke width (``smoke_variant``: fp32 compute, d_model 128, ds 16, chunk
8; mamba2 2 layers, zamba2 12 = 2 groups of 6 Mamba2 layers, each
followed by the shared attention+MLP block), plus a zamba2 of 8 layers,
whose 2 layers after its one group form the Mamba-only tail that the
full-width model has.  The same weights (JAX's ``registry.init(cfg, 0)``
carried across with ``params_from_numpy``) and numpy-made tokens go
through both packages:

* train-mode logits, with the scan's plain path and with ``use_pallas``
  (the JAX Pallas kernel in interpret mode against kernel B6's twin);
* the caches a prefill emits (conv window, SSD state, and zamba2's
  shared-block K/V at each application site) and its last logits;
* greedy token streams; inside the port, prefill + decode equals the
  argmax of the teacher-forced forward, and the dense-slot batcher,
  asked for pages, serves dense slots and streams the greedy tokens;
* zamba2 with an int8 KV cache: greedy tokens equal to JAX's, and the
  batcher's (with and without ``decode_flash``) equal to greedy;
* a prompt shorter than the conv window is rejected at ``submit``, in
  the batcher and through the serving CLI, and the requests beside it
  are served.

Tolerances: fp32 logits and states to 2e-4 absolute (the SSD tests'
tolerance: sums in other orders, through up to 12 layers; measured
< 3e-5), bf16 K/V to one bf16 ulp of the JAX value (both round an fp32
value that may differ in its last bits) plus 1e-5 absolute (near 0 the
fp32 values themselves differ by a few 1e-6 after cancellation; measured
3.8e-6).  Tokens must be identical.
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys
import threading

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
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry
from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                        RequestFailed, drain)
from repro_torch.serve.serve_loop import greedy_generate as tgreedy

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4
KV_FLOOR = 1e-5      # fp32 cancellation near 0, before the bf16 rounding
# config name -> (arch, fields replaced on both packages' smoke configs)
MODELS = {"mamba2": ("mamba2-1p3b", {}),
          "zamba2": ("zamba2-1p2b", {}),
          "zamba2-tail": ("zamba2-1p2b", {"n_layers": 8})}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX config, port config, JAX params, the same params bridged)."""
    arch, kw = MODELS[name]
    jcfg = dataclasses.replace(jsmoke(jconfigs.get(arch)), **kw)
    tcfg = dataclasses.replace(tsmoke(tconfigs.get(arch)), **kw)
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    err = np.abs(got.detach().float().numpy()
                 - np.asarray(want, np.float32)).max()
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_logits_match_jax(name, use_pallas):
    jcfg, tcfg, jp, tp = _model(name)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    tok = _tokens((2, 24), 1)                    # 3 chunks of 8
    want = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                             mode="train")
    before = ssd_scan.launches
    got = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert ssd_scan.launches == before           # CPU: the twin
    assert got.shape == (2, 24, tcfg.padded_vocab)
    _close(got, want)


def _jax_caches(jcfg, cache):
    """The JAX prefill cache in the port's layout: Mamba2 leaves stacked
    over all layers in order (zamba2: groups then tail), attention K/V
    over the shared block's application sites."""
    if jcfg.family == "ssm":
        return {"ssm": cache, "attn": None}
    grp = cache["groups"]
    ssm = {}
    for n, a in grp["ssm"].items():
        a = np.asarray(a)
        a = a.reshape((-1,) + a.shape[2:])
        if "tail" in cache:
            a = np.concatenate([a, np.asarray(cache["tail"][n])])
        ssm[n] = a
    return {"ssm": ssm, "attn": grp["attn"]}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_logits_and_caches_match_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    tok = _tokens((2, 13), 2)
    max_seq = 24
    last = np.full((2,), 12, np.int32)
    jl, jc = jregistry.forward(jcfg, jp, {"tokens": jnp.asarray(tok)},
                               mode="prefill", cache_len=max_seq,
                               last_pos=jnp.asarray(last))
    tl, tc = tregistry.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)},
                               mode="prefill", cache_len=max_seq,
                               last_pos=torch.from_numpy(last))
    _close(tl, jl)
    want = _jax_caches(jcfg, jc)
    got = {"ssm": tc, "attn": None} if tcfg.family == "ssm" else tc
    for n in ("conv", "ssd"):
        assert tuple(got["ssm"][n].shape) == want["ssm"][n].shape
        assert got["ssm"][n].dtype == torch.float32
        _close(got["ssm"][n], want["ssm"][n])
    if want["attn"] is not None:
        for n in ("k", "v"):
            g = got["attn"][n].float().numpy()
            w = np.asarray(want["attn"][n].astype(jnp.float32))
            assert g.shape == w.shape
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert np.all(np.abs(g - w) <= ulp + KV_FLOOR)
    # the fresh batcher cache has the emitted cache's layout, slot axis 1.
    decl = tregistry.cache_decls(tcfg, 2, max_seq)
    assert tparams.tree_map(lambda _, d: d.shape, decl) == tparams.tree_map(
        lambda _, a: tuple(a.shape), tc)


@pytest.mark.parametrize("name", ["mamba2", "zamba2-tail"])
def test_greedy_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    tok = _tokens((2, 9), 3)
    want = np.asarray(jgreedy(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              steps=6, max_seq=24))
    got = tgreedy(tcfg, tp, {"tokens": tok}, steps=6, max_seq=24,
                  device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_decode_matches_teacher_forced(name):
    """prefill + greedy decode == argmax of the teacher-forced forward at
    each position (the conv window, SSD state and shared-block K/V carried
    right), as ``tests/test_models.py`` checks the reference."""
    _, tcfg, _, tp = _model(name)
    prompt_len, steps = 8, 4
    tok = _tokens((1, prompt_len), 4)
    gen = tgreedy(tcfg, tp, {"tokens": tok}, steps=steps,
                  max_seq=prompt_len + steps + 2, device="cpu")
    full = torch.from_numpy(np.concatenate([tok, gen], axis=1))
    logits = tregistry.forward(tcfg, tp, {"tokens": full})
    pred = logits[0, prompt_len - 1:prompt_len - 1 + steps].argmax(-1)
    np.testing.assert_array_equal(pred.numpy(), gen[0])


def _run(cfg, params, prompts, max_news, **kw):
    bat = ContinuousBatcher(cfg, params, device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join(timeout=60)
    assert not prod.is_alive()
    return [drain(r) for r in reqs], bat


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_batcher_ignores_page_size_and_matches_greedy(name):
    """No pageable layout: ``kv_page_size`` is ignored (dense slots),
    prompts are admitted at their exact length, and the streams equal the
    greedy tokens, with slots reused and zamba2's shared block decoding
    through B3's twin."""
    _, tcfg, _, tp = _model(name)
    cfg = dataclasses.replace(tcfg, kv_page_size=8, decode_flash=True)
    prompts = [_tokens((n,), 10 + n) for n in (6, 9, 4)]
    max_news = [3, 5, 4]
    gold = [list(tgreedy(tcfg, tp, {"tokens": p[None]}, steps=m,
                         max_seq=24, device="cpu")[0])
            for p, m in zip(prompts, max_news)]
    got, bat = _run(cfg, tp, prompts, max_news, n_slots=2, max_seq=24)
    assert not bat.paged and bat.stats()["paged"] is False
    assert [bat._bucket_for(n) for n in (3, 6, 9)] == [3, 6, 9]
    assert got == gold


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_prompt_shorter_than_the_conv_window_raises(name):
    """The reference's prefill emits a conv state of fewer than K - 1
    rows for such a prompt, and its decode then fails; the port says so
    at prefill."""
    _, tcfg, _, tp = _model(name)
    with pytest.raises(ValueError, match="conv window"):
        tgreedy(tcfg, tp, {"tokens": _tokens((1, 2), 5)}, steps=2,
                max_seq=16, device="cpu")


def test_serve_cli_serves_recurrent_families_dense():
    """zamba2 through the CLI: --page-size falls back to dense slots,
    --decode-flash reaches the shared block's decode attention."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1p2b", "--smoke", "--device", "cpu", "--requests", "4",
         "--slots", "2",
         "--prompt-len", "12", "--max-new", "5", "--max-seq", "48",
         "--page-size", "8", "--decode-flash"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum(line.startswith("req ") for line in lines) == 4
    assert "4 requests, 20 tokens in" in lines[-1]
    assert ", dense," in lines[-1]


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_short_prompt_is_rejected_and_its_neighbour_served(name):
    """A prompt shorter than the conv window's K - 1 inputs is rejected at
    ``submit`` (a ``ValueError``, and a ``RequestFailed`` in its stream);
    the batcher lives on and serves a well-formed request submitted
    beside it with its greedy tokens."""
    _, tcfg, _, tp = _model(name)
    bat = ContinuousBatcher(tcfg, tp, device="cpu", n_slots=2, max_seq=24)
    bad = Request(rid=0, prompt=_tokens((tcfg.ssm_conv - 2,), 20), max_new=3)
    good = Request(rid=1, prompt=_tokens((6,), 21), max_new=4)
    with pytest.raises(ValueError, match="conv window"):
        bat.submit(bad)
    bat.submit(good)
    bat.run(1)
    with pytest.raises(RequestFailed) as failed:
        drain(bad)
    assert "conv window" in failed.value.reason
    gold = list(tgreedy(tcfg, tp, {"tokens": good.prompt[None]}, steps=4,
                        max_seq=24, device="cpu")[0])
    assert drain(good) == gold


def test_serve_cli_reports_a_short_recurrent_prompt():
    """``--prompt-len 2`` on mamba2: every request is reported rejected,
    and the CLI ends normally with its summary line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-1p3b", "--smoke", "--device", "cpu", "--requests", "3",
         "--slots", "2", "--prompt-len", "2", "--max-new", "4",
         "--max-seq", "24"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    rejected = [ln for ln in lines if ln.startswith("req ")
                and "RequestFailed" in ln and "conv window" in ln]
    assert len(rejected) == 3, out.stdout
    assert lines[-1].startswith("3 requests, 0 tokens in"), out.stdout


def test_zamba2_int8_kv_matches_jax_and_the_batcher():
    """zamba2 with an int8 KV cache for its shared attention block: the
    port's greedy tokens equal the JAX package's, and the dense-slot
    batcher, with and without ``decode_flash`` (B3's twin), streams the
    port's greedy tokens."""
    jcfg, tcfg, jp, tp = _model("zamba2")
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    tok = _tokens((2, 9), 30)
    want = np.asarray(jgreedy(jcfg, jp, {"tokens": jnp.asarray(tok)},
                              steps=6, max_seq=24))
    got = tgreedy(tcfg, tp, {"tokens": tok}, steps=6, max_seq=24,
                  device="cpu")
    np.testing.assert_array_equal(got, want)
    prompts = [_tokens((n,), 31 + n) for n in (6, 9, 4)]
    max_news = [3, 5, 4]
    gold = [list(tgreedy(tcfg, tp, {"tokens": p[None]}, steps=m,
                         max_seq=24, device="cpu")[0])
            for p, m in zip(prompts, max_news)]
    for flash in (False, True):
        cfg = dataclasses.replace(tcfg, decode_flash=flash)
        streams, bat = _run(cfg, tp, prompts, max_news, n_slots=2,
                            max_seq=24)
        assert not bat.paged
        assert streams == gold, flash
