"""Sharded serving on (1, 2) gloo ranks of the CPU, one 2-rank launch for
the module (``_torch_serve_rank_fns.mesh12``): the contracts of the
reference's ``tests/test_sharded_serving.py`` held on the port.

* The five paged families (flat GQA, MoE, gemma3's ring + global, MLA
  latent pages, int8 + scale pages) stream the port's one-process
  tokens on every rank, and each rank holds half the KV pool bytes
  (MLA: strictly less, its rope pages stay whole).
* Across frameworks: minitron on (1, 2) streams the JAX package's
  one-device batcher's tokens on the same weights (the JAX side runs
  here, in the parent).
* Speculation with the drafter firing, and ``decode_flash`` (B1's twin
  on the CPU), at per-shard head counts.
* Host page movement under split pools: a prefix rehit, and preempt,
  spill and resume with the allocator clean after.
"""

import dataclasses

import numpy as np
import pytest

import _torch_serve_rank_fns as R
from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro_torch.models import params as PP


@pytest.fixture(scope="module")
def jax_minitron():
    jcfg = dataclasses.replace(jsmoke(jconfigs.get("minitron-4b")),
                               kv_page_size=8, prefill_chunk=8)
    jp = jregistry.init(jcfg, 0)
    return jcfg, jp, PP.tree_map(lambda _, a: np.asarray(a), jp)


@pytest.fixture(scope="module")
def ranks(jax_minitron, tmp_path_factory):
    return run_ranks(2, "_torch_serve_rank_fns:mesh12",
                     tmp_path_factory.mktemp("mesh12"), jax_minitron[2])


def one_process(arch, **kw):
    cfg = R.smoke(arch, **kw)
    return R.serve(cfg, R.params_for(cfg), R.PROMPTS, R.NEWS)[0]


@pytest.mark.parametrize("name", list(R.FAMILIES))
def test_sharded_identity_across_families(ranks, name):
    """(1, 2) streams == one process for every paged family, on both
    ranks; the pool bytes per shard halve exactly (MLA: drop strictly)
    and every page is back in its pool."""
    arch, kw = R.FAMILIES[name]
    want = one_process(arch, **kw)
    for got in ranks:
        f = got["families"][name]
        assert f["streams"] == want, (name, want, f["streams"])
        m = f["mesh"]
        assert m["shape"] == (1, 2) and m["axes"] == ("data", "model")
        assert m["tp"] == 2
        per, tot = m["pool_bytes_per_shard"], m["pool_bytes_total"]
        if name.startswith("deepseek"):
            assert per < tot < 2 * per, (per, tot)
            assert m["collectives_per_decode_step"]["all_gather"] == 1 + 2
        else:
            assert 2 * per == tot, (per, tot)
            assert m["collectives_per_decode_step"]["all_gather"] == 1
        assert f["used"] == 0


def test_sharded_stream_equals_jax_one_device_batcher(ranks, jax_minitron):
    """minitron on (1, 2) from the JAX package's weights streams the JAX
    package's one-device paged batcher's tokens."""
    jcfg, jp, _ = jax_minitron
    bat = jbatching.ContinuousBatcher(jcfg, jp, n_slots=2, max_seq=48)
    reqs = [jbatching.Request(rid=i, prompt=np.asarray(p, np.int32),
                              max_new=m)
            for i, (p, m) in enumerate(zip(R.PROMPTS, R.NEWS))]
    for r in reqs:
        bat.requests.Push(r)
    bat.requests.close()
    bat.run(len(reqs))
    want = [jbatching.drain(r) for r in reqs]
    for got in ranks:
        assert got["jax_weights"] == want


def test_sharded_speculation_and_decode_flash(ranks):
    """The verify step and B1's block-table decode run per shard; both
    stay equal to one process, with the drafter firing."""
    base = R.smoke("minitron-4b")
    reps = R.motif_prompts()
    want = R.serve(base, R.params_for(base), reps, [16, 16])[0]
    want_f = R.serve(base, R.params_for(base), reps, [10, 10])[0]
    for got in ranks:
        assert got["spec"]["streams"] == want
        sp = got["spec"]["stats"]
        assert sp["drafted"] > 0 and sp["verify_steps"] > 0, sp
        assert got["flash"] == want_f


def test_sharded_prefix_rehit_and_preempt_resume(ranks):
    """A prefix rehit attaches shared pages into split pools, and a
    preempt / spill / resume cycle moves full-width payloads: both give
    one process's streams, and no page stays in use."""
    base = R.smoke("minitron-4b")
    pcfg = dataclasses.replace(base, prefix_cache=True)
    import repro_torch.serve.batching as B
    bat = B.ContinuousBatcher(pcfg, R.params_for(pcfg), n_slots=2,
                              max_seq=64, device="cpu")
    P = R.shared_prompt(pcfg)
    want = R.serve_seq(bat, [P, P], [5, 5])
    prompts, news, ppcfg = R.preempt_case(base)
    want2 = R.serve(ppcfg, R.params_for(ppcfg), prompts, news,
                    max_seq=32)[0]
    for got in ranks:
        assert got["rehit"] == {"streams": want, "hits": 1}
        p = got["preempt"]
        assert p["streams"] == want2
        assert p["preemptions"] > 0 and p["resumes"] > 0
        assert p["used"] == 0
