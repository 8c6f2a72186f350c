"""Rank bodies of the sharded-serving port tests (run by ``_torch_ranks``):
each takes (rank, world, *args) inside a gloo process group of the CPU
and returns token streams and counters.  Imports torch and the port
only; the tests compare against the port's one-process batcher (the
helpers below, called in the parent) and the JAX package's one-device
batcher, both in the parent."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.distributed import sharding as SH
from repro_torch.models import params as PP
from repro_torch.models import registry
from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                        RequestFailed, drain)

PROMPTS = [list(range(5, 13)), list(range(40, 52)), [7, 9, 11]]
NEWS = [8, 8, 8]
# the families of the reference's identity matrix: flat GQA, MoE experts,
# gemma3's local ring + global, MLA latent pages, int8 + scale pages.
FAMILIES = {
    "minitron-4b": ("minitron-4b", {}),
    "phi3p5-moe-42b": ("phi3p5-moe-42b", {}),
    "gemma3-12b": ("gemma3-12b", {}),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "minitron-4b int8": ("minitron-4b", {"kv_cache_dtype": "int8"}),
}


def smoke(arch, **kw):
    return dataclasses.replace(smoke_variant(configs.get(arch)),
                               kv_page_size=8, prefill_chunk=8, **kw)


def params_for(cfg, weights=None):
    """The port's seed-0 weights, or ``weights`` (numpy) carried over."""
    if weights is not None:
        return PP.params_from_numpy(weights, "cpu")
    return registry.init(cfg, seed=0, device="cpu")


def serve(cfg, params, prompts, max_news, n_slots=2, max_seq=48,
          reqs=None, submit_delay=0.0, **bkw):
    """Streams of ``prompts`` through one batcher, submitted from a
    producer thread (``submit_delay`` seconds before each)."""
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device="cpu", **bkw)
    reqs = reqs or [Request(rid=i, prompt=np.asarray(p, np.int32),
                            max_new=m)
                    for i, (p, m) in enumerate(zip(prompts, max_news))]

    def produce():
        for r in reqs:
            time.sleep(submit_delay)
            bat.submit(r)

    t = threading.Thread(target=produce)
    t.start()
    bat.run(len(reqs))
    t.join(timeout=60)
    assert not t.is_alive()
    return [drain(r, timeout=30) for r in reqs], bat


def serve_seq(bat, prompts, max_news):
    """One request at a time: each retires before the next is sent."""
    outs = []
    for i, (p, mn) in enumerate(zip(prompts, max_news)):
        r = Request(rid=i, prompt=np.asarray(p, np.int32), max_new=mn)
        t = threading.Thread(target=lambda r=r: bat.submit(r))
        t.start()
        bat.run(bat.retired + 1)
        t.join(timeout=60)
        outs.append(drain(r, timeout=30))
    return outs


def motif_prompts():
    motif = np.asarray([7, 3, 11, 5], np.int32)
    return [list(np.tile(motif, 3)[:9]), list(np.tile(motif, 4)[:14])]


def shared_prompt(cfg, n=24, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def tier_cfg(cfg, snapshot):
    return dataclasses.replace(cfg, prefix_cache=True,
                               kv_host_tier_bytes=1 << 20,
                               tier_restore_min_tokens=0,
                               kv_tier_snapshot=snapshot)


def preempt_case(base):
    return ([list(range(20, 28)), list(range(60, 68))], [8, 8],
            dataclasses.replace(base, kv_page_size=4))


# --- (1, 2): the five families, speculation, B1's twin, page movement ----------------


def mesh12(rank, world, minitron_weights):
    mesh = (1, 2)
    out = {"families": {}}
    for name, (arch, kw) in FAMILIES.items():
        cfg = smoke(arch, mesh_shape=mesh, **kw)
        streams, b = serve(cfg, params_for(cfg), PROMPTS, NEWS)
        out["families"][name] = {"streams": streams,
                                 "mesh": b.stats()["mesh"],
                                 "used": b.total_used_pages()}
    # the across-frameworks case: the JAX package's weights.
    cfg = smoke("minitron-4b", mesh_shape=mesh)
    out["jax_weights"], _ = serve(cfg, params_for(cfg, minitron_weights),
                                  PROMPTS, NEWS)
    # speculation with the drafter firing, and B1's twin.
    reps = motif_prompts()
    scfg = smoke("minitron-4b", speculate_k=4, speculate_ngram=1,
                 mesh_shape=mesh)
    streams, b = serve(scfg, params_for(scfg), reps, [16, 16])
    out["spec"] = {"streams": streams, "stats": b.stats()["speculation"]}
    fcfg = smoke("minitron-4b", decode_flash=True, mesh_shape=mesh)
    out["flash"], _ = serve(fcfg, params_for(fcfg), reps, [10, 10])
    # a prefix rehit, then preempt / spill / resume.
    pcfg = smoke("minitron-4b", prefix_cache=True, mesh_shape=mesh)
    bat = ContinuousBatcher(pcfg, params_for(pcfg), n_slots=2, max_seq=64,
                            device="cpu")
    P = shared_prompt(pcfg)
    out["rehit"] = {"streams": serve_seq(bat, [P, P], [5, 5]),
                    "hits": bat.prefix_hits}
    prompts, news, ppcfg = preempt_case(smoke("minitron-4b", mesh_shape=mesh))
    streams, b = serve(ppcfg, params_for(ppcfg), prompts, news, max_seq=32,
                       n_pages=5)
    out["preempt"] = {"streams": streams, "preemptions": b.preemptions,
                      "resumes": b.resumes, "used": b.total_used_pages()}
    return out


def snapshot12(rank, world, snapshot):
    """A T2 snapshot written on (1, 2) after one cold request."""
    tcfg = tier_cfg(smoke("minitron-4b", mesh_shape=(1, 2)), snapshot)
    bat = ContinuousBatcher(tcfg, params_for(tcfg), n_slots=2, max_seq=64,
                            device="cpu")
    streams = serve_seq(bat, [shared_prompt(tcfg)], [5])
    bat.save_tier_snapshot()
    return {"streams": streams,
            "demotions": bat._tiers.stats()["demotions"]}


# --- wider meshes: (1, 4), (2, 2), (4,); the snapshot on (1, 4) --------------------


def mesh4(rank, world, snapshot):
    out = {}
    for shape in [(1, 4), (2, 2), (4,)]:
        cfg = smoke("minitron-4b", mesh_shape=shape)
        streams, b = serve(cfg, params_for(cfg), PROMPTS, NEWS)
        out[shape] = {"streams": streams, "mesh": b.stats()["mesh"]}
    tcfg = tier_cfg(smoke("minitron-4b", mesh_shape=(1, 4)), snapshot)
    bat = ContinuousBatcher(tcfg, params_for(tcfg), n_slots=2, max_seq=64,
                            device="cpu")
    loaded = bat._tiers.stats()["snapshot_loaded"]
    streams = serve_seq(bat, [shared_prompt(tcfg)], [5])
    out["restored"] = {"streams": streams, "loaded": loaded,
                       "rehits": bat._tiers.stats()["rehits"],
                       "chunks": bat.prefill_chunks}
    out["bits"] = replicated_bits(rank, world)
    return out


def replicated_bits(rank, world):
    """``psum_parts`` and ``gather_parts`` over a 4-rank group on inputs
    that differ by rank (fp32 and bf16, values whose sum depends on the
    order of the adds): each rank's result as raw bytes."""
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(64, 96, generator=gen) * 10 ** torch.randint(
        -3, 4, (64, 96), generator=gen).float()
    out = {}
    with SH.manual_axis(dist.group.WORLD):
        assert SH.part_index() == rank and SH.part_count() == world
        for dt in (torch.float32, torch.bfloat16):
            xs = x.to(dt)
            out[f"psum {dt}"] = SH.psum_parts(xs).view(torch.uint8).numpy()
            out[f"gather {dt}"] = SH.gather_parts(xs, 1).view(
                torch.uint8).numpy()
    return out


# --- lockstep under a skewed clock and late arrivals --------------------------------


class _SkewedClock:
    """Monotonic time at ``rate`` seconds per second, plus ``offset``."""

    def __init__(self, offset, rate):
        self.offset, self.rate = offset, rate

    def __call__(self):
        return time.monotonic() * self.rate + self.offset


def lockstep(rank, world):
    """Rank 1's clock stands still an hour ahead, and its producer sends
    every request 0.3 s late; request 3 carries a 1 ms deadline, which
    has passed on rank 0's clock by the time a slot frees for it (on
    rank 1's own clock it never would).  Returns each request's tokens
    and its outcome."""
    cfg = smoke("minitron-4b", mesh_shape=(1, 2))
    prompts = PROMPTS + [list(range(90, 100)), list(range(30, 37))]
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=8,
                    deadline_ms=1.0 if i == 3 else None)
            for i, p in enumerate(prompts)]
    bat = ContinuousBatcher(cfg, params_for(cfg), n_slots=2, max_seq=48,
                            device="cpu",
                            clock=_SkewedClock(3600.0 * rank,
                                               0.0 if rank else 1.0))

    def produce():
        for r in reqs:
            time.sleep(0.3 * rank)
            bat.submit(r)

    t = threading.Thread(target=produce)
    t.start()
    bat.run(len(reqs))
    t.join(timeout=60)
    outcomes = []
    for r in reqs:
        try:
            outcomes.append(("retired", drain(r, timeout=30)))
        except RequestFailed as e:
            outcomes.append((type(e).__name__, list(e.tokens)))
    st = bat.stats()
    return {"outcomes": outcomes, "expired": st["expired"],
            "retired": st["retired"], "steps": st["steps"]}


def lone_fault(rank, world, how):
    """Rank 1 alone cannot follow rank 0: its requests carry other ids
    (``how == "other"``: every rank submits before it serves, and rank
    1 fails following rank 0's first non-blocking pop), or none reach
    it within its follow timeout (``"late"``: rank 0's arrive 0.5 s
    into the serve, so both ranks wait in the loop's blocking pop, the
    path that retries on a timeout of its own).  Each rank then records
    each request's outcome (``drain`` with a short timeout: "hang" if
    no terminal event came), prints them to stderr as one JSON line and
    re-raises its error, so a rank that failed leaves the group without
    joining another collective."""
    import json
    import sys

    from repro_torch.serve import lockstep
    cfg = smoke("minitron-4b", mesh_shape=(1, 2))
    alone = rank == 1
    if alone and how == "late":
        lockstep.FOLLOW_TIMEOUT_S = 1.0
    reqs = [Request(rid=i + (100 if alone and how == "other" else 0),
                    prompt=np.asarray(p, np.int32), max_new=8)
            for i, p in enumerate(PROMPTS)]
    if alone and how == "late":
        reqs = []
    bat = ContinuousBatcher(cfg, params_for(cfg), n_slots=2, max_seq=48,
                            device="cpu")

    def produce():
        time.sleep(0.5 if how == "late" else 0.0)
        for r in reqs:
            bat.submit(r)

    t = threading.Thread(target=produce)
    if how == "late":
        t.start()
    else:
        produce()
    error = None
    try:
        bat.run(len(PROMPTS))
    except Exception as e:           # noqa: BLE001 - reported, re-raised
        error = e
    if t.is_alive():
        t.join(timeout=30)
    outcomes = []
    for r in reqs:
        try:
            drain(r, timeout=5)
            outcomes.append("retired")
        except RequestFailed as e:
            outcomes.append(type(e).__name__)
        except TimeoutError:
            outcomes.append("hang")
    print("OUTCOMES " + json.dumps({"error": type(error).__name__,
                                    "outcomes": outcomes}),
          file=sys.stderr, flush=True)
    if error is not None:
        raise error
    return outcomes


def tiles12(rank, world):
    """``serve_loop.init_tiles`` on (1, 2): per family, whether each leaf
    equals the tile ``cut_tiles`` makes of the whole init, and the
    streams of a batcher given the tiles beside one given the whole
    weights."""
    from repro_torch.serve.serve_loop import (cut_tiles, init_tiles,
                                              mesh_coords,
                                              paged_sharding_specs,
                                              serving_mesh_for)
    out = {}
    for name in ("minitron-4b", "phi3p5-moe-42b", "deepseek-v2-lite-16b"):
        cfg = smoke(name, mesh_shape=(1, 2))
        tiles = init_tiles(cfg, 0, device="cpu")
        sizes, coords = mesh_coords(serving_mesh_for(cfg)[0])
        specs, _ = paged_sharding_specs(cfg, cfg.kv_page_size, sizes)
        cut = cut_tiles(params_for(cfg), specs, sizes, coords)
        same = all(PP.tree_leaves(PP.tree_map(
            lambda path, t: torch.equal(t, PP.tree_at(cut, path)), tiles)))
        out[name] = {"equal": same,
                     "bytes": sum(t.numel() * t.element_size()
                                  for t in PP.tree_leaves(tiles))}
        if name == "minitron-4b":
            got, b = serve(cfg, tiles, PROMPTS, NEWS)
            out["streams_from_tiles"] = got
            out["param_bytes_per_shard"] = b.stats()["mesh"][
                "param_bytes_per_shard"]
            out["streams_from_whole"] = serve(cfg, params_for(cfg),
                                              PROMPTS, NEWS)[0]
    return out


def cli(rank, world):
    """``launch.serve.main`` with ``--mesh 1x2`` on each rank; rank 0's
    standard output."""
    import contextlib
    import io
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--arch", "minitron-4b", "--smoke", "--page-size", "8",
              "--requests", "2", "--slots", "2", "--prompt-len", "6",
              "--max-new", "4", "--mesh", "1x2", "--device", "cpu"])
    return buf.getvalue()
