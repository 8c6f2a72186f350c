#!/usr/bin/env python3
"""Kernels launched and B2 time per int8 decode step of one tree of the
port, on one CUDA card.

    python3 scripts/int8_step_profile.py [TREE] [--seed N]

TREE (default: the repository root) holds ``src/repro_torch``; the script
imports that tree's package, which builds its kernels inside TREE.  It
draws full-width minitron-4b (random bf16 weights from the seed) with an
int8 KV cache and decodes 8 slots admitted at 100-900 positions, from
dense slots (B3 + B2) and from page pools prefilled through the chunk
step (B1 + B2).  For each it profiles 5 decode steps with
``torch.profiler`` and prints, per step: the wall time (host clock), the
device busy time, the kernels launched (copies and fills apart), and
B2's quantize and dequantize kernels, launches and device ms.  Run it for
two trees in one call to compare them on one card
(``scripts/chip_smoke_ab.sh`` runs it after each tree's chip_smoke).
Prints one JSON line, beginning ``int8 step profile``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
N_SLOTS, MAX_SEQ, PAGE, CHUNK, STEPS = 8, 1024, 16, 128, 5


def b2_class(name: str):
    if "kv_dequantize" in name:
        return "dequantize"
    if "kv_quantize" in name:
        return "quantize"
    return None


def profile_steps(fn):
    """Per-step numbers of ``fn`` (one decode step ending in a device to
    host copy) over STEPS unprofiled and STEPS profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        fn()
    wall = (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            fn()
    busy, kernels, copies = 0.0, 0, 0
    b2 = {c: {"launches": 0, "ms": 0.0} for c in ("quantize", "dequantize")}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy += us
        if ev.name.startswith(("Memcpy", "Memset")):
            copies += 1
            continue
        kernels += 1
        c = b2_class(ev.name)
        if c:
            b2[c]["launches"] += 1
            b2[c]["ms"] += us / 1e3
    for c in b2.values():
        c["launches"] /= STEPS
        c["ms"] /= STEPS
    busy_ms = busy / STEPS / 1e3
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if busy else "not measured",
            "kernels_per_step": kernels / STEPS,
            "copies_per_step": copies / STEPS,
            "b2_per_step": b2}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_step_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.serve_loop import (make_chunk_prefill_step,
                                              make_paged_decode_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get("minitron-4b"), decode_flash=True,
                               kv_cache_dtype="int8")
    params = registry.init(base, args.seed, device=DEVICE,
                           dtype=torch.bfloat16)
    rng = np.random.default_rng(args.seed)
    plens = rng.integers(100, 900, N_SLOTS)
    prompts = [rng.integers(0, base.vocab_size, int(n)).astype(np.int32)
               for n in plens]
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}

    # dense slots: one batched prefill per bucket, then decode steps.
    bat = ContinuousBatcher(base, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                            device=DEVICE)
    for i, p in enumerate(prompts):
        bat.requests.Push(Request(rid=i, prompt=p, max_new=4))
    bat.admit()
    pos, remaining = bat.pos.clone(), bat.remaining + 1000
    active = torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)

    def dense_once():
        nonlocal pos
        _, _, pos, _, _, o = bat._step(params, bat.cache, bat.last_tok, pos,
                                       remaining, active)
        o.cpu()

    out["dense int8"] = profile_steps(dense_once)
    del bat
    torch.cuda.empty_cache()

    # page pools: every slot prefilled through the chunk step.
    cfg = dataclasses.replace(base, kv_page_size=PAGE, prefill_chunk=CHUNK)
    nb = MAX_SEQ // PAGE
    pools = PP.init_params(registry.paged_cache_decls(cfg, N_SLOTS * nb,
                                                      PAGE), device=DEVICE)
    bt = torch.arange(N_SLOTS * nb, device=DEVICE, dtype=torch.int32).reshape(
        N_SLOTS, nb)
    zero = torch.zeros(N_SLOTS, dtype=torch.int32, device=DEVICE)
    state = [zero.clone(), zero.clone(), zero.clone(), zero.bool()]
    chunk_fn = make_chunk_prefill_step(cfg, CHUNK, MAX_SEQ, PAGE)
    for s, p in enumerate(prompts):
        for base_pos in range(0, len(p), CHUNK):
            seg = np.zeros((1, CHUNK), np.int64)
            part = p[base_pos:base_pos + CHUNK]
            seg[0, :len(part)] = part
            final = base_pos + CHUNK >= len(p)
            last = (len(p) - 1 - base_pos) if final else CHUNK - 1
            pools, *state, _ = chunk_fn(
                params, pools, {"kv": bt}, *state,
                torch.from_numpy(seg).to(DEVICE),
                torch.full((1,), base_pos, dtype=torch.int32, device=DEVICE),
                torch.full((1,), int(last), dtype=torch.int32, device=DEVICE),
                s, final, len(p), 4, 0)
    step = make_paged_decode_step(cfg, MAX_SEQ, PAGE)
    last_tok, pos = state[0], state[1]

    def paged_once():
        nonlocal pos
        _, _, pos, _, _, o = step(params, pools, {"kv": bt}, last_tok, pos,
                                  remaining, active)
        o.cpu()

    out["paged int8"] = profile_steps(paged_once)
    print("int8 step profile: " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
