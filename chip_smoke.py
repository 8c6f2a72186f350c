#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and the script exits non-zero) on failure:

1. device and build — the card's name and power limit, the CUDA kernels
   built from ``src/repro_torch/csrc`` with nvcc, TF32 off;
2. kernel vs plain — ``flash_attention_decode_paged`` against its plain
   PyTorch twin at the main path's shapes, a long-context shape and every
   option, with timings beside the bound and a library yardstick;
3. exactness at smoke width — the paged batcher through the kernel gives
   the dense greedy oracle's tokens, with and without preemption;
4. full-width serve — minitron-4b at full width, random bf16 weights
   from the seed, 16 requests through ``ContinuousBatcher`` under
   ``DataflowContext``, every decode step through the kernel.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository around it, it exits non-zero and prints no result.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/csrc/flash_decode_paged.cu"
KERNEL_REPLACES = "src/repro/kernels/flash_attention.py:523"
# bf16 outputs: kernel and plain both accumulate in fp32 and round once,
# so they differ by a few bf16 ulps at |out| < 1.  fp32 outputs differ
# only by summation order over <= 4096 keys.
TOL_BF16 = 1e-2
TOL_F32 = 1e-4
# full-width logits (bf16 compute, 32 layers): one decode step through
# the kernel vs through the plain path, relative to the largest logit.
TOL_LOGITS_REL = 5e-2
# the library yardstick rounds scores/probabilities in bf16 inside its
# own kernel, so it is held to the plain version more loosely.
TOL_LIBRARY = 5e-2
# NVIDIA data sheets: HBM bandwidth (bytes/s) by H100 part; dense bf16
# tensor-core peak (operations/s) for the bf16 inputs the bound is
# computed for.
HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "": 3.35e12}
PEAK_BF16 = 989e12


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE.items():
        if key and key in name:
            return rate
    return HBM_RATE[""]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` (CUDA events), with the L2 cache
    flushed before each run: a decode step finds each layer's pages cold."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# --- phase 2: kernel vs plain ---------------------------------------------------------


def make_case(gen, *, b, hq=24, hkv=8, sq=1, d=128, page=16, n_blocks,
              max_pos, q_dtype=torch.bfloat16, quant=False, window=None,
              ring=False, unallocated=False):
    dev = DEVICE
    n_pages = b * n_blocks
    shape = (n_pages, hkv, page, d)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks, vs = ((torch.rand(shape[:3] + (1,), generator=gen, device=dev)
                   * 0.015 + 0.005).bfloat16() for _ in range(2))
    else:
        kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        ks = vs = None
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(q_dtype)
    bt = torch.randperm(n_pages, generator=gen, device=dev).reshape(
        b, n_blocks).int()
    pos = torch.randint(max_pos // 8, max_pos - sq + 1, (b,), generator=gen,
                        device=dev).int()
    if unallocated:             # entries past each sequence's pages
        live = (pos.long() + sq - 1) // page
        cols = torch.arange(n_blocks, device=dev)[None, :]
        bt = torch.where(cols > live[:, None], n_pages + 7, bt).int()
    base = None
    if ring:
        cur = pos.long()[:, None] // page
        j = torch.arange(n_blocks, device=dev)[None, :]
        base = ((cur - ((cur - j) % n_blocks)) * page).int().contiguous()
    return dict(q=q, k_pages=kp, v_pages=vp, block_tab=bt.contiguous(),
                pos=pos, window=window, page_base=base, k_scale_pages=ks,
                v_scale_pages=vs)


def live_pages(c) -> int:
    """Pages the kernel must read for these inputs (its skipping rule)."""
    b, _, sq, _ = c["q"].shape
    page = c["k_pages"].shape[2]
    nb = c["block_tab"].shape[1]
    pos = c["pos"].long()[:, None]
    start = (c["page_base"].long() if c["page_base"] is not None
             else (torch.arange(nb, device=DEVICE) * page)[None, :])
    act = start <= pos + sq - 1
    if c["page_base"] is not None:
        act &= start >= 0
    if c["window"] is not None:
        act &= start + page - 1 > pos - c["window"]
    return int(act.sum())


def bound_ms(c, card: str):
    """Least time for the work: max(bytes / HBM rate, ops / peak)."""
    q, kp = c["q"], c["k_pages"]
    b, hq, sq, d = q.shape
    _, hkv, page, _ = kp.shape
    n_live = live_pages(c)
    per_page = hkv * page * d * kp.element_size() * 2
    if c["k_scale_pages"] is not None:
        per_page += hkv * page * 2 * 2
    nbytes = (n_live * per_page + 2 * q.numel() * q.element_size()
              + c["block_tab"].numel() * 4 + b * 4)
    keys = n_live * page                    # summed over sequences
    ops = 4.0 * (hq // hkv) * sq * d * keys * hkv
    t_bytes = nbytes / hbm_rate(card) * 1e3
    t_ops = ops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(c):
    """Pre-gathered contiguous K/V (b, hkv, S, d) and the boolean mask for
    the library yardstick (flat tables, no window, sq = 1)."""
    kp, vp, bt = c["k_pages"], c["v_pages"], c["block_tab"].long()
    b, nb = bt.shape
    _, hkv, page, d = kp.shape
    S = nb * page
    K = kp[bt].transpose(1, 2).reshape(b, hkv, S, d).contiguous()
    V = vp[bt].transpose(1, 2).reshape(b, hkv, S, d).contiguous()
    mask = (torch.arange(S, device=DEVICE)[None, :]
            <= c["pos"].long()[:, None])[:, None, None, :]
    return K, V, mask


def phase_kernel(gen, card, flush):
    from repro_torch.kernels.flash_attention import (
        flash_attention_decode_paged as kernel,
        flash_attention_decode_paged_plain as plain)
    main = dict(b=8, n_blocks=64, max_pos=1024)
    cases = {
        "main (8 seqs, pos <= 1k, bf16)": main,
        "long (32 seqs x 4096 pos, bf16)": dict(b=32, n_blocks=256,
                                                max_pos=4096),
        "sq=4 verify span": dict(main, sq=4),
        "window=256": dict(main, window=256),
        "ring page_base, window=100": dict(
            main, n_blocks=-(-100 // 16) + 1, window=100, ring=True),
        "int8 + bf16 scales": dict(main, quant=True),
        "f32 q": dict(main, q_dtype=torch.float32),
        "table entries >= n_pages": dict(main, unallocated=True),
    }
    results = {}
    for name, kw in cases.items():
        c = make_case(gen, **kw)
        out = kernel(**c)
        torch.cuda.synchronize()
        ref = plain(**c)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL_F32 if c["q"].dtype == torch.float32 else TOL_BF16
        check(err <= tol, f"kernel vs plain [{name}]: {err} > {tol}")
        row = {"max_abs_err": err, "tol": tol}
        if name.startswith(("main", "long")):
            row["ms"] = time_ms(lambda: kernel(**c), flush)
            row["plain_ms"] = time_ms(lambda: plain(**c), flush)
            K, V, mask = sdpa_inputs(c)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = sdpa(c["q"], K, V, attn_mask=mask, enable_gqa=True)
            lib_err = (lib.float() - ref.float()).abs().max().item()
            check(lib_err <= TOL_LIBRARY,
                  f"library yardstick disagrees [{name}]: {lib_err}")
            # yardstick only (the port never calls it): SDPA over K/V
            # gathered beforehand, so its time excludes the gather.
            row["library_ms"] = time_ms(
                lambda: sdpa(c["q"], K, V, attn_mask=mask, enable_gqa=True),
                flush)
            row["library"] = "sdpa on pre-gathered K/V, gather excluded"
            row["bound_ms"], row["bound_by"] = bound_ms(c, card)
            row["live_pages"] = live_pages(c)
            del K, V, mask
        results[name] = row
        print(f"kernel vs plain [{name}]: " + json.dumps(row))
        del c, out, ref
    torch.cuda.empty_cache()
    return results


# --- phase 3: exactness at smoke width ------------------------------------------------


def run_batcher(cfg, params, prompts, max_news, **kw):
    import threading
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    bat = ContinuousBatcher(cfg, params, device=DEVICE, **kw)
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    prod = threading.Thread(target=lambda: [bat.submit(r) for r in reqs])
    prod.start()
    bat.run(len(reqs))
    prod.join()
    return [drain(r) for r in reqs], bat


def phase_exactness(seed):
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.kernels.flash_attention import (
        flash_attention_decode_paged as kernel)
    from repro_torch.models import registry
    from repro_torch.serve.serve_loop import greedy_generate
    base = smoke_variant(get("minitron-4b"))
    params = registry.init(base, seed, device=DEVICE)
    cfg = dataclasses.replace(base, kv_page_size=8, decode_flash=True)
    rng = np.random.default_rng(seed)
    plens, max_news = [5, 11, 19], [14, 12, 10]
    prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
               for n in plens]
    gold = [list(greedy_generate(base, params, {"tokens": p[None]}, steps=m,
                                 max_seq=48, device=DEVICE)[0])
            for p, m in zip(prompts, max_news)]
    before = kernel.launches
    got, bat = run_batcher(cfg, params, prompts, max_news, n_slots=3,
                           max_seq=48, prefill_chunk=32)
    check(got == gold, f"paged+kernel {got} != dense greedy {gold}")
    check(kernel.launches - before == bat.steps * cfg.n_layers,
          "smoke batcher did not decode through the kernel")
    got, bat = run_batcher(cfg, params, prompts, max_news, n_slots=3,
                           max_seq=48, prefill_chunk=32, n_pages=5)
    check(bat.preemptions > 0, "small pool did not force a preemption")
    check(got == gold, f"preempted paged+kernel {got} != dense {gold}")
    check(bat.total_used_pages() == 0, "pages leaked")
    print(f"smoke exactness: 3 requests token-identical to dense greedy; "
          f"with a 5-page pool too ({bat.preemptions} preemptions, "
          f"{bat.resumes} resumes)")


# --- phase 4: full-width serve --------------------------------------------------------


def profile_window(fn, n: int):
    """Wall time per call of ``fn`` (which must end in a synchronizing
    copy) over ``n`` unprofiled calls, then device busy time per call from
    a ``torch.profiler`` trace of ``n`` more: the sum of the card's kernel
    and copy intervals (one stream, so they do not overlap), split into
    the paged decode kernel, matrix products and everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
    split = {"flash_decode_paged": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name
        if "flash_decode_paged" in name:
            split["flash_decode_paged"] += us
        elif any(k in name for k in ("gemm", "nvjet", "cublas", "cutlass",
                                     "splitKreduce")):
            split["matmul"] += us
        else:
            split["other"] += us
    busy = sum(split.values()) / n / 1e3
    out = {"wall_ms": wall * 1e3,
           "device_busy_ms": busy if busy else "not measured"}
    if busy:
        out["device_idle_share"] = 1.0 - busy / (wall * 1e3)
        out.update({f"{k}_ms": v / n / 1e3 for k, v in split.items()})
    return out



def phase_full_width(seed):
    from repro_torch.configs import get
    from repro_torch.core.dataflow import DataflowContext
    from repro_torch.core.stream import Stream
    from repro_torch.kernels.flash_attention import (
        flash_attention_decode_paged as kernel)
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    from repro_torch.serve.serve_loop import (make_chunk_prefill_step,
                                              make_paged_decode_step as
                                              make_decode_step)

    class StampedStream(Stream):
        """Response stream that notes when its first token arrives."""

        def __init__(self):
            super().__init__(depth=4096, name="resp")
            self.first_at = None

        def Push(self, value, timeout=None):
            if self.first_at is None:
                self.first_at = time.perf_counter()
            super().Push(value, timeout)

    n_slots, n_req, max_new, max_seq, page, chunk = 8, 16, 64, 1024, 16, 128
    cfg = dataclasses.replace(get("minitron-4b"), kv_page_size=page,
                              decode_flash=True, prefill_chunk=chunk)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = registry.init(cfg, seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in PP.tree_leaves(params))
    print(f"full width: minitron-4b, {n_params} bf16 parameters drawn on the "
          f"card in {time.perf_counter() - t:.2f}s")
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(256, 513))).astype(np.int32),
        max_new=max_new, out=StampedStream()) for i in range(n_req)]
    bat = ContinuousBatcher(cfg, params, n_slots=n_slots, max_seq=max_seq,
                            device=DEVICE)
    step_s = []
    inner_step = bat.step

    def timed_step():
        t0 = time.perf_counter()
        n = inner_step()            # ends in the (2, n_slots) device->host copy
        step_s.append(time.perf_counter() - t0)
        return n

    bat.step = timed_step
    submitted = {}

    def producer():
        for r in reqs:
            submitted[r.rid] = time.perf_counter()
            bat.submit(r)

    kernel.launches = 0
    t0 = time.perf_counter()
    with DataflowContext() as df:
        df.function(producer, name="producer")
        df.function(bat.run, len(reqs), name="batcher")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches

    outs = [drain(r) for r in reqs]
    check(all(len(o) == max_new for o in outs),
          f"token counts {[len(o) for o in outs]} != {max_new}")
    check(all(0 <= t < cfg.padded_vocab for o in outs for t in o),
          "token id out of range")
    check(bat.total_used_pages() == 0, "pages leaked")
    check(launches == bat.steps * cfg.n_layers,
          f"kernel launches {launches} != steps {bat.steps} x layers "
          f"{cfg.n_layers}")
    tokens = sum(len(o) for o in outs)
    ttft = [r.out.first_at - submitted[r.rid] for r in reqs]
    summary = {
        "requests": n_req, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": bat.steps,
        "prefill_chunks": bat.prefill_chunks,
        "median_step_ms": statistics.median(step_s) * 1e3,
        "ttft_median_s": statistics.median(ttft), "ttft_max_s": max(ttft),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "kernel_launches": launches,
    }
    print("full-width serve: " + json.dumps(summary))

    # one decode step's logits, kernel vs plain, on prefilled pools.
    nb = max_seq // page
    pools = PP.init_params(registry.paged_cache_decls(cfg, n_slots * nb, page),
                           device=DEVICE)
    bt = torch.arange(n_slots * nb, device=DEVICE, dtype=torch.int32).reshape(
        n_slots, nb)
    zero = torch.zeros(n_slots, dtype=torch.int32, device=DEVICE)
    state = [zero.clone(), zero.clone(), zero.clone(), zero.bool()]
    fn = make_chunk_prefill_step(cfg, chunk, max_seq, page)
    plens = rng.integers(100, 900, n_slots)
    for s, plen in enumerate(plens):
        prompt = rng.integers(0, cfg.vocab_size, int(plen))
        for base in range(0, int(plen), chunk):
            seg = np.zeros((1, chunk), np.int64)
            part = prompt[base:base + chunk]
            seg[0, :len(part)] = part
            final = base + chunk >= plen
            last = (plen - 1 - base) if final else chunk - 1
            pools, *state, _ = fn(
                params, pools, {"kv": bt}, *state,
                torch.from_numpy(seg).to(DEVICE),
                torch.full((1,), base, dtype=torch.int32, device=DEVICE),
                torch.full((1,), int(last), dtype=torch.int32, device=DEVICE),
                s, final, int(plen), 4, 0)
    last_tok, pos = state[0], state[1]
    logits = {}
    for flash in (True, False):
        c = dataclasses.replace(cfg, decode_flash=flash)
        logits[flash], _ = registry.forward(
            c, params, {"tokens": last_tok[:, None].long()}, mode="decode",
            cache={"pages": pools, "block_tab": {"kv": bt}}, pos=pos)
    a, b = logits[True].float(), logits[False].float()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"full-width decode logits, kernel vs plain: max_abs_err {err:.4g} "
          f"(max |logit| {scale:.4g}, rel tol {TOL_LOGITS_REL}), argmax "
          f"agreement {agree:.3f}")
    check(torch.isfinite(a).all().item(), "non-finite logits")
    check(err <= TOL_LOGITS_REL * scale, "full-width logits disagree")

    # where a decode step's and a prefill chunk's time goes.
    step = make_decode_step(cfg, max_seq, page)
    active = torch.ones(n_slots, dtype=torch.bool, device=DEVICE)

    def decode_once():
        nonlocal pos
        _, _, pos, _, _, out = step(params, pools, {"kv": bt}, last_tok,
                                    pos, state[2] + 1000, active)
        out.cpu()

    seg = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, chunk))).to(
        DEVICE)

    def chunk_once():
        *_, tok = fn(params, pools, {"kv": bt}, *state, seg,
                     torch.zeros(1, dtype=torch.int32, device=DEVICE),
                     torch.full((1,), chunk - 1, dtype=torch.int32,
                                device=DEVICE), 0, False, chunk, 4, 0)
        tok.cpu()

    for f in (decode_once, chunk_once):
        f()
    prof = {"decode_step": profile_window(decode_once, 5),
            "prefill_chunk_128": profile_window(chunk_once, 3)}
    print("time split (8 slots at ~100-900 positions): " + json.dumps(prof))
    return summary, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = torch.cuda.get_device_name(0)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reports = build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.2f}s "
          f"({', '.join(sorted(reports)) or 'up to date'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    kres = phase_kernel(gen, card, flush)
    del flush
    phase_exactness(args.seed)
    _, launches = phase_full_width(args.seed)

    m = kres["main (8 seqs, pos <= 1k, bf16)"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_decode_paged", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": m["max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
