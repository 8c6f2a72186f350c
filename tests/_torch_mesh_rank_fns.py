"""Rank bodies of the mesh port tests (run by ``_torch_ranks``): the host
tier's per-rank tiles, shedding in lockstep, and the dense-cache serve
steps on a ``DeviceMesh``.  Each takes (rank, world, *args) inside a
gloo process group of the CPU.  Imports torch and the port only; the
tests compare against one-process runs and the JAX package in the
parent."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from _torch_serve_rank_fns import (params_for, serve_seq, shared_prompt,
                                   smoke)
from repro_torch.models import params as PP
from repro_torch.serve.batching import (ContinuousBatcher, Request,
                                        RequestFailed, drain)

# --- C7: each rank's host tier holds its own tiles ---------------------------------

TIER_NEWS = [5, 5, 5]
_TIMING = ("gather_seconds", "scatter_seconds")


def tier_case(mesh_shape=(), **kw):
    """(cfg, prompts): a prompt, a filler that evicts it from a 6-page
    pool (a demote to T1), and the prompt again (a T1 rehit)."""
    cfg = dataclasses.replace(
        smoke("minitron-4b", mesh_shape=mesh_shape, **kw), prefix_cache=True,
        kv_host_tier_bytes=1 << 20, tier_restore_min_tokens=0)
    p = shared_prompt(cfg, 32, seed=42)
    f = shared_prompt(cfg, 32, seed=43)
    return cfg, [p, f, p]


def tier_serve(cfg, prompts):
    """Streams, the tier counters and the bytes the T1 store's tensors
    hold, of one batcher serving ``prompts`` one after another."""
    bat = ContinuousBatcher(cfg, params_for(cfg), n_slots=1, max_seq=64,
                            n_pages=6, device="cpu")
    streams = serve_seq(bat, prompts, TIER_NEWS)
    tiers = {k: v for k, v in bat.stats()["tiers"].items()
             if k not in _TIMING}
    held = sum(t.numel() * t.element_size()
               for _, e in bat._tiers.store.items_lru_order()
               for tree in e.data.values() for t in PP.tree_leaves(tree))
    return {"streams": streams, "tiers": tiers, "held": held}


def tier_shards(rank, world):
    """The tier case on (1, 2), bf16 and int8 pages."""
    return {kv: tier_serve(*tier_case((1, world), kv_cache_dtype=kv))
            for kv in ("bfloat16", "int8")}


# --- A13d: shedding at a full queue, decided by rank 0 ------------------------------

SHED_PROMPTS = [list(range(5 + 3 * i, 13 + 3 * i)) for i in range(8)]
SHED_NEW = 6


def _outcomes(reqs):
    out = []
    for r in reqs:
        try:
            out.append(("retired", drain(r, timeout=30)))
        except RequestFailed as e:
            out.append((type(e).__name__, str(e)))
    return out


def shed(rank, world):
    """``overload="reject"`` on (1, 2) with a queue of depth 2.  Rank 1's
    producer is late: 0.3 s before its first request, 0.05 s before each
    one after it.  Phase one submits four requests before the loop runs
    (two fit, two are shed); phase two submits the rest while the loop
    serves and then closes the stream, which ends the loop.  Returns
    each request's outcome, ``submit``'s answers, the rejections and the
    retired count."""
    cfg = smoke("minitron-4b", mesh_shape=(1, world))
    bat = ContinuousBatcher(cfg, params_for(cfg), n_slots=1, max_seq=48,
                            device="cpu", overload="reject", queue_depth=2)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=SHED_NEW)
            for i, p in enumerate(SHED_PROMPTS)]
    answers = []

    def produce(batch, first_delay):
        time.sleep(first_delay * rank)
        for r in batch:
            answers.append(bat.submit(r))
            time.sleep(0.05 * rank)

    t = threading.Thread(target=produce, args=(reqs[:4], 0.3))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()

    def phase_two():
        produce(reqs[4:], 0.3)
        bat.requests.close()

    t = threading.Thread(target=phase_two)
    t.start()
    bat.run(len(reqs))
    t.join(timeout=60)
    assert not t.is_alive()
    st = bat.stats()
    return {"outcomes": _outcomes(reqs), "answers": answers,
            "rejections": st["rejections"], "retired": st["retired"]}


# --- A13c: the dense-cache serve steps on a DeviceMesh ------------------------------


def qwen_seq_cfg(**kw):
    """qwen1p5-32b's smoke variant with int8 caches split over the
    sequence (``decode_seq_shard``)."""
    from repro_torch import configs
    from repro_torch.configs.base import smoke_variant
    return dataclasses.replace(smoke_variant(configs.get("qwen1p5-32b")),
                               kv_cache_dtype="int8", decode_seq_shard=True,
                               **kw)


def mesh_greedy(cfg, params, prompt, steps, max_seq, mesh=None):
    """Greedy tokens of ``serve_loop.make_serve_steps`` (on ``mesh``, or
    on one process): prefill, then ``steps`` decode steps at one shared
    position, as the reference's test drives them.  Returns (tokens (b,
    steps) int64, the first step's logits as fp32 numpy, the cache's
    placements by leaf name)."""
    from repro_torch.serve.serve_loop import make_serve_steps
    from repro_torch.distributed import sharding as SH
    b, s = prompt.shape
    pre, dec, _, _ = make_serve_steps(cfg, b, max_seq, mesh)

    def whole(t):
        return t.full_tensor() if SH.is_dtensor(t) else t
    with torch.no_grad():
        logits, cache = pre(params, {"tokens": torch.as_tensor(prompt)})
        first = whole(logits).float().numpy()
        toks, pos = [], s
        for _ in range(steps):
            nxt = torch.argmax(whole(logits)[:, -1], -1)[:, None]
            toks.append(nxt)
            logits, cache = dec(params, cache, {"tokens": nxt}, pos)
            pos += 1
    placements = by_path(cache, lambda t: tuple(map(str, t.placements))
                         if SH.is_dtensor(t) else None)
    return torch.cat(toks, 1).numpy(), first, placements


def by_path(tree, fn):
    """{"a/b": fn(leaf)} of a tree of nested dicts."""
    out = {}
    PP.tree_map(lambda path, t: out.__setitem__("/".join(path), fn(t)),
                tree)
    return out


def serve_steps_mesh(rank, world, shape, axes, weights, prompt, steps,
                     max_seq):
    """``mesh_greedy`` of ``qwen_seq_cfg`` on a mesh of ``shape`` over
    ``axes`` on these gloo ranks (``weights``: numpy parameters carried
    over), with the cache's specs reckoned from the mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    cfg = qwen_seq_cfg()
    mesh = make_host_mesh(shape, axes, device_type="cpu")
    params = PP.params_from_numpy(weights, "cpu")
    toks, first, placements = mesh_greedy(cfg, params, prompt, steps,
                                          max_seq, mesh)
    specs = PP.param_specs(registry.cache_decls(cfg, prompt.shape[0],
                                                max_seq), mesh)
    return {"tokens": toks, "first": first, "placements": placements,
            "specs": by_path(specs, tuple)}


BATCH1_ARCHS = ("minitron-4b", "gemma3-12b", "deepseek-v2-lite-16b",
                "zamba2-1p2b", "mamba2-1p3b")


def batch1_cfg(arch):
    from repro_torch import configs
    from repro_torch.configs.base import smoke_variant
    return smoke_variant(configs.get(arch))


def batch1_prompt(cfg):
    return np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int64)


def serve_steps_batch1(rank, world, weights):
    """``mesh_greedy`` at batch 1 on a (2, 2) mesh for every family with
    a dense cache: the reference's long-context layout, each attention
    cache's sequence over "data" (``seq_sharded``), MLA's latent rows
    too, gemma3's global layers (its windowed local ones stay whole), the
    recurrent state over its heads.  ``weights``: {arch: numpy
    parameters carried over}.  Returns {arch: (tokens, first-step
    logits, the cache's placements)}."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    for arch in BATCH1_ARCHS:
        cfg = batch1_cfg(arch)
        out[arch] = mesh_greedy(cfg, PP.params_from_numpy(weights[arch], "cpu"),
                                batch1_prompt(cfg), 4, 32, mesh)
    return out
