#!/usr/bin/env python3
"""A dense prefill's time and card memory for one or more trees of the
port, on one CUDA card.

    python3 scripts/prefill_ab.py TREE [TREE ...] [--seed N]

Each TREE (a directory holding ``src/repro_torch``) runs in a process of
its own, in the order given: give parent, change, change, parent, so
that host drift shows as a spread and not as a difference between the
sides.  In each, ``registry.forward(mode="prefill")`` of full-width
minitron-4b (random bf16 weights from the seed) at (b, s) = (8, 512) (a
dense admission of 256-512-token prompts, one bucket), (1, 2048) and
(1, 8192), and of gemma3-12b at 24 of its 48 layers at (8, 2048) (its
dense admission's bucket for 1100-1500-token prompts); then one
minitron layer's attention at (8, 512) alone, as one masked softmax
(``layers.attention_xla``) and as the blocked online softmax
(``layers._attention_blocked_fwd``, one 512 x 512 tile); last a single
minitron prefill at (1, 16384).  For each: the median wall ms of 3
CUDA-synchronised calls after a warm-up (host clock; the (1, 16384)
prefill: one call), and the peak memory a call adds over what was
allocated before it (``torch.cuda.max_memory_allocated``: the scores,
the logits and the emitted cache).  A call that runs out of memory is
reported as ``"oom"``.  Prints the card line, then one JSON line per tree
and measurement, beginning ``prefill ab``.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
REPEATS = 3


def measure(fn, repeats=REPEATS):
    """(median wall ms, peak bytes over the allocation before the call)
    of ``fn``; ``repeats`` 1: a single call, no warm-up."""
    if repeats > 1:
        fn()
    times = []
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    peak = torch.cuda.max_memory_allocated() - before
    return sorted(times)[len(times) // 2], peak


def worker(tree, seed):
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.configs import get
    from repro_torch.models import layers
    from repro_torch.models import registry

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def report(model, b, s, what, fn, repeats=REPEATS):
        rec = {"tree": tree, "model": model, "b": b, "s": s, "what": what}
        try:
            ms, peak = measure(fn, repeats)
            rec.update(ms=ms, peak_gb=peak / 1e9)
        except torch.cuda.OutOfMemoryError:
            rec["ms"] = rec["peak_gb"] = "oom"
        torch.cuda.empty_cache()
        print("prefill ab " + json.dumps(rec), flush=True)

    def prefills(name, cfg, shapes, repeats=REPEATS):
        params = registry.init(cfg, seed, device=DEVICE, dtype=torch.bfloat16)
        for b, s in shapes:
            tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                device=DEVICE)

            def fn(tok=tok, s=s):
                with torch.no_grad():
                    return registry.forward(cfg, params, {"tokens": tok},
                                            mode="prefill", cache_len=s)
            report(name, b, s, "prefill", fn, repeats)
        del params
        torch.cuda.empty_cache()

    minitron = get("minitron-4b")
    prefills("minitron-4b", minitron, [(8, 512), (1, 2048), (1, 8192)])
    prefills("gemma3-12b, 24 layers",
             dataclasses.replace(get("gemma3-12b"), n_layers=24), [(8, 2048)])

    b, s, hq, hkv, d = 8, 512, minitron.n_heads, minitron.n_kv_heads, \
        minitron.head_dim
    q = torch.randn(b, hq, s, d, generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=DEVICE).bfloat16()
            for _ in range(2))
    scale = 1.0 / d ** 0.5
    report("minitron-4b, one layer", b, s, "attention, one masked softmax",
           lambda: layers.attention_xla(q, k, v, scale=scale))
    report("minitron-4b, one layer", b, s,
           "attention, blocked online softmax (one tile)",
           lambda: layers._attention_blocked_fwd(q, k, v, True, None, scale,
                                                 512, 512, False, False)[0])
    del q, k, v
    prefills("minitron-4b", minitron, [(1, 16384)], repeats=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        worker(os.path.abspath(args.worker), args.seed)
        return 0
    if not args.trees:
        ap.error("give at least one TREE")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    status = 0
    for tree in args.trees:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", tree, "--seed", str(args.seed)])
        status = status or r.returncode
    return status


if __name__ == "__main__":
    sys.exit(main())
