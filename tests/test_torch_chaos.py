"""Port parity: the chaos matrix of ``tests/test_resilience.py`` (fault
site x page family) on the port's paged batcher with the host tier,
minitron-4b smoke, JAX's weights bridged.

Under every injected fault, each request ends (every drain is bounded),
only the affected request errors (with the injected cause), every
allocator is consistent afterwards, every surviving stream is
bit-identical to the fault-free run, and the fault really fired.  The
degradation-ladder sites (``t1_d2h``, ``t1_h2d``, ``alloc``) never kill a
request: retries fall through to recompute, which is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.serve.batching import ContinuousBatcher, Request, drain
from repro_torch.serve.resilience import (InjectedFault, RequestErrored,
                                          RequestFailed, ServeSupervisor)

torch.set_num_threads(2)

_CHAOS_SITES = ["step:2", "chunk:2", "t1_d2h:1+", "t1_h2d:1+", "alloc:3..5"]


@pytest.fixture(scope="module")
def params():
    jp = jregistry.init(jsmoke(jconfigs.get("minitron-4b")), 0)
    return tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")


def _reqs(cfg, n, max_new, plen):
    return [Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, cfg.vocab_size, plen).astype(np.int32), max_new=max_new)
        for i in range(n)]


def _serve(cfg, params, faults=None):
    # a tight pool forces demotion, and 20 new tokens per request outgrow
    # it, so preemption spills and restores: every t1_* site sees
    # traffic.  restore_min=0 prefers restore over recompute.
    bat = ContinuousBatcher(cfg, params, n_slots=2, max_seq=64,
                            queue_depth=64, n_pages=8, faults=faults,
                            device="cpu")
    sup = ServeSupervisor(bat, max_restarts=2)
    reqs = _reqs(cfg, 4, max_new=20, plen=16)
    for r in reqs:
        bat.submit(r)
    sup.run(len(reqs))
    outs = {}
    for r in reqs:
        try:
            outs[r.rid] = (drain(r, timeout=10.0), None)
        except RequestFailed as e:
            outs[r.rid] = (e.tokens, e)
    return bat, sup, outs


@pytest.mark.filterwarnings("ignore:tier:UserWarning")
@pytest.mark.filterwarnings("ignore:host KV tier:UserWarning")
@pytest.mark.parametrize("family", ["bf16", "int8"])
@pytest.mark.parametrize("site", _CHAOS_SITES)
def test_chaos_matrix(params, family, site):
    cfg = dataclasses.replace(
        tsmoke(tconfigs.get("minitron-4b")), kv_page_size=8,
        prefill_chunk=8, prefix_cache=True, kv_host_tier_bytes=1 << 20,
        tier_restore_min_tokens=0,
        kv_cache_dtype="int8" if family == "int8" else "bfloat16")
    gold_bat, _, gold = _serve(cfg, params)
    assert all(e is None for _, e in gold.values())
    assert gold_bat.stats()["tier_faults"] == 0
    assert gold_bat.preemptions > 0 and gold_bat._tiers.demotions > 0
    bat, sup, outs = _serve(cfg, params, faults=site)
    assert bat._fault.fired.get(site.split(":")[0]), f"{site} never fired"
    for rid, (toks, e) in outs.items():
        if e is not None:
            assert isinstance(e, RequestErrored)
            assert isinstance(e.__cause__, InjectedFault)
            continue
        assert toks == gold[rid][0], \
            f"rid {rid} diverged under fault {site} ({family})"
    errs = sum(1 for _, e in outs.values() if e is not None)
    if site.startswith(("t1_", "alloc")):
        assert errs == 0
        assert sup.report.faults == 0
    if site.startswith("step"):
        assert sup.report.restarts == 1 and errs == 0
    assert errs <= 1
    for alloc in bat._alloc.values():
        alloc.check_consistency()
    assert bat.retired == len(outs)
