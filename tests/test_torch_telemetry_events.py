"""Port parity: the telemetry event sequence against the JAX batcher.

The same requests (minitron-4b smoke, JAX's weights bridged) through the
port's batcher and the reference's, each with its own ``ServeTelemetry``
on its own tick clock, all submitted before ``run`` so both runs are
single-threaded: the sequence of ``(rid, name, phase, args)`` events, the
time-valued args (``queue_s``, ``ttft_s``) left out, is the reference's
on a plain paged run, a paged run whose pool forces preemption (spill
and restore), and a dense-slot run.  The streamed tokens and the
histogram counts agree too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve import batching as jbatching
from repro.serve import telemetry as jtel
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.serve import batching as tbatching
from repro_torch.serve import telemetry as ttel

torch.set_num_threads(2)

TIME_ARGS = ("queue_s", "ttft_s")


@pytest.fixture(scope="module")
def model():
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(jcfg, 0)
    tp = tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu")
    return tsmoke(tconfigs.get("minitron-4b")), tp, jcfg, jp


def _tick_clock(start=100.0, dt=1e-3):
    t = [start]

    def clk():
        t[0] += dt
        return t[0]

    return clk


def _serve(batching, telemetry, cfg, params, prompts, max_news, **kw):
    tel = telemetry.ServeTelemetry(clock=_tick_clock())
    bat = batching.ContinuousBatcher(cfg, params, n_slots=2, max_seq=48,
                                     queue_depth=8, telemetry=tel, **kw)
    reqs = [batching.Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    for r in reqs:
        bat.submit(r)
    bat.run(len(reqs))
    outs = [batching.drain(r, timeout=10.0) for r in reqs]
    events = [(e["rid"], e["name"], e["ph"],
               {k: v for k, v in e.get("args", {}).items()
                if k not in TIME_ARGS})
              for e in tel.tracer.events()]
    counts = {k: v["count"] for k, v in tel.latency_summary().items()}
    return outs, events, counts, bat


CASES = {
    "paged": dict(kv_page_size=8, prefill_chunk=8),
    "paged, preempting": dict(kv_page_size=8, prefill_chunk=8),
    "dense": dict(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_event_sequence_equals_the_jax_batchers(model, case):
    cfg, tp, jcfg, jp = model
    rng = np.random.default_rng(4)
    plens, max_news = [11, 9, 14, 6], [8, 6, 7, 9]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in plens]
    kw = {"n_pages": 4} if "preempting" in case else {}
    want = _serve(jbatching, jtel, dataclasses.replace(jcfg, **CASES[case]),
                  jp, prompts, max_news, **kw)
    got = _serve(tbatching, ttel, dataclasses.replace(cfg, **CASES[case]),
                 tp, prompts, max_news, device="cpu", **kw)
    assert got[0] == want[0]                       # tokens
    assert got[1] == want[1]                       # events
    assert got[2] == want[2]                       # histogram counts
    names = {name for _, name, _, _ in got[1]}
    assert {"submit", "first_token", "token", "decode_step", "retire",
            "request"} <= names
    if case.startswith("paged"):
        assert {"admit", "prefill_chunk"} <= names
    if "preempting" in case:
        assert got[3].preemptions == want[3].preemptions >= 1
        assert {"preempt", "spill", "restore", "resume"} <= names
