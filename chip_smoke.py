#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and the script exits non-zero) on failure:

1. device and build — the card's name and power limit, the CUDA kernels
   built from ``src/repro_torch/csrc`` with nvcc (one process per source,
   all started together), registers and spills of each B5 and B1 kernel,
   and the count of tensor-core instructions in B5's SASS (each bf16
   kernel must have some), TF32 off;
2. kernels vs plain — every kernel against its plain PyTorch twin on the
   card: ``flash_attention_decode_paged`` (B1) and
   ``flash_attention_decode`` (B3) at the main path's shapes (B1 also at
   the served verify span, 8 sequences at sq = 5, bf16 and int8), a long
   shape and every option (B3 also at zamba2's attention widths and at
   its split-KV edges, each row with its ``n_split``), and both at
   gemma3-12b's served shapes, d 256 with 16 / 8 heads (B1: the local
   layers' ring of 65 pages with ``page_base`` under a 1024 window at
   positions 1100-1560, its verify span at sq = 5 on the 66-page ring,
   int8 pages, the global layers' flat table; B3: the rolled ring of
   S == window == 1024 and the global 2048), both at phi3.5-moe's served
   shapes, 32 / 8 heads of 128 (a GQA group of 4; B1 also at its verify
   span sq = 5), B3 at paligemma-3b's (8 / 1 heads of 256, S 512) and
   musicgen-medium's (24 / 24 heads of 64, S 512), timed beside SDPA on
   the same pre-gathered K/V with the same mask,
   ``kv_quantize``/``kv_dequantize`` (B2) bit for bit at decode, prefill
   and full-cache shapes, B2's quantize-and-store entry
   ``kv_quantize_store`` bit for bit (every cache leaf after the store) at
   the full-width path's dense and paged shapes, slots on a ring and
   clamped, dropped rows, fp32 rows and .5 quotients, timed beside the
   separate route (two quantize launches, then indexed writes), the hlslib
   kernels ``stencil2d`` (B8) and
   ``tree_row_reduce`` (B7) bit for bit (by the bits, at both its
   regimes, a warp per row and long rows split over CTAs, and at every
   vector edge, each row with its split count) and ``rmsnorm`` (B4) and
   ``flash_attention`` (B5) within tolerance at their main shapes, long
   shapes and options, and ``ssd_scan`` (B6) within the JAX tests'
   tolerance at one mamba2 layer's train shape, a long sequence,
   zamba2's widths and small odd shapes, with its ``ValueError`` on a
   ragged length; each timed beside its bound and, where one PyTorch
   call computes the same function, that library yardstick;
3. the hlslib host runtime and exactness at smoke width — the paper's
   Listing 2 through ``Context()`` on the card (``ExecuteTask`` returns
   finished results equal to the expected values), ``fused_pipeline``
   equal to sequential composition, the quickstart twin's lines equal to
   its CPU run's; the paged batcher through B1 and the
   dense-slot batcher through B3 (bf16, the sliding-window ring, int8
   through B2, and bf16 at max_seq 512, where B3 splits each slot over
   CTAs) give the dense greedy oracle's tokens; the int8 paged
   batcher gives the int8 dense-slot batcher's, with preemption; B2's
   launches on both int8 runs are held to exact counts; the prefix
   cache's hit gives the cold run's tokens, ``prefill_exact`` the same
   pool bits however the prompt is chunked, and speculative decode
   (``speculate_k`` 4, verify spans through B1 at sq = 5, bf16 and int8
   pools, with a prefix re-hit) plain decode's tokens, every allocator
   consistent with no page in use at the end;
   mamba2-1p3b and zamba2-1p2b (fp32) serve dense slots when asked for
   pages, token-identical to their greedy oracle (zamba2's shared block
   through B3), and their train forward through B6 matches the plain
   scan; gemma3 (fp32, window 16, prompts past it) gives the dense
   greedy oracle's tokens from dense slots through B3 on the ring, the
   dense slots' tokens paged through B1 with ``page_base`` (also with
   pools that preempt; bf16 and int8), one request's pages within the
   ring plus the global table, and plain decode's tokens with
   ``speculate_k`` 4, B1 and B3 launched steps x layers; tiered KV memory
   and resilient serving (fp32, page movement through the staged
   engine's copy stream and pinned buffers): a T1 rehit gives the tokens
   of a device-resident hit and of a cold run, spill/restore and
   recompute preemption those of a run never preempted, a snapshot
   restart pays only the catch-up chunk, a bit-flipped or truncated
   snapshot gives a cold start, and the chaos matrix (step:2, chunk:2,
   t1_d2h:1+, t1_h2d:1+, alloc:3..5; bf16 and int8 pages) under the
   supervisor keeps every survivor bit-identical to the fault-free run
   with only the affected request errored and every allocator
   consistent (step:2 recovered by a supervised restart); fault-free
   runs show no tier fault and no supervisor fault or restart; the moe
   family (fp32, 2 layers): phi3.5-moe paged through B1 gives its dense
   slots' tokens through B3 (launches steps x layers), deepseek on MLA
   latent pages its dense slots', a prefix hit the cold run's,
   ``speculate_k`` 4 plain decode's and a preempting pool the
   unpreempted run's, and 12 dense slots at capacity factor 0.05 (each
   row its own MoE capacity) each request's tokens served alone; the
   vlm and audio families (fp32, 2 layers): paligemma-3b's and
   musicgen-medium's ``greedy_generate`` tokens through B3 equal the
   plain decode's and the argmax of the train forward at each position
   (B3 launched steps x layers), and the batcher refuses both;
4. full-width serve — minitron-4b at full width, random bf16 weights
   from the seed, 16 requests through ``ContinuousBatcher`` under
   ``DataflowContext``: paged through B1, then dense slots through B3 with
   a bf16 and with an int8 cache (B2, exact launch counts); each with one
   decode step's logits through the kernels vs the plain path, and a
   decode step's time split with the kernels it launches; then int8 page
   pools prefilled through the chunk step, its decode and chunk steps'
   B2 launches counted exactly and their time split; an int8 dense and
   an int8 paged decode step each run through B2's store kernel and
   through its plain twin from copies of one cache, the caches after
   them equal bit for bit; then 16 requests sharing a 512-token system
   prompt (32-128 own tokens each cycling a motif) served paged through
   B1, plain and with the prefix cache, ``prefill_exact`` and
   ``speculate_k`` 4 (B1 launched layers x (decode + verify steps),
   drafts and prefix hits required, prefix, speculation and TTFT
   counters printed), one verify span held against sequential decode
   steps from copies of the same pools, and a verify step's time split
   beside a decode step's; then the tiered serve: three rounds (families
   A, B, A) of 16 requests, 4 distinct 512-token system prompts shared by
   4 requests each, with a 1 GiB host tier on a pool of the live pages
   at peak plus 96 (fewer than a family's cached blocks), so round B
   demotes A's blocks and round 3 promotes them; the same rounds with
   ``host_tier_bytes=0`` (round 3 recomputes) and A twice on a pool that
   keeps it on the card; B1 launched (decode + verify steps) x 32 in
   every round, demotions and rehits required, no tier fault, round 3
   through T1 bit-identical to round 3 from device-resident hits;
   tokens/s, TTFTs, the tier counters, the staged engine's GB/s beside a
   pinned ``copy_`` of the same bytes and the restore-vs-recompute
   crossover at 16-512 tokens printed;
5. the hlslib ops path at full size — the package example's eager
   ``ShiftReg`` stage at 64 x 128 on the host against the kernel's sweep,
   then its kernel stages (``ops.stencil(use_pallas=True)`` and 64 sweeps
   of ``stencil2d_iterated``) on a 16384 x 16384 fp32 grid, and
   ``ops.row_reduce``, ``ops.fused_rmsnorm`` and ``ops.attention`` at
   their main shapes, all with ``use_pallas=True``; outputs against the
   plain twins on the card (the stencil's 64 sweeps bit for bit);
6. the recurrent families at full width — mamba2-1p3b and zamba2-1p2b,
   random bf16 weights from the seed: phase 4's traffic through the
   dense-slot batcher (exact-length admission; zamba2 with
   ``decode_flash``), zamba2's decode logits through B3 vs the plain
   path, a decode step's time split, then one train forward each at
   b 4 x s 2048 through B6 (48 and 38 launches) with its time split; its
   logits are held to the plain scan's in fp32 compute (bf16 rounding
   through the random-weight layers amplifies any change of summation
   order past the tolerance: the plain scan at half the chunk is printed
   beside it as that noise floor);
7. gemma3-12b at full width, 12 of its 48 layers (2 of its 8
   local/global groups) — random bf16 weights from the seed, 16
   requests of 1100-1500 prompt tokens (past the 1024 window) and 64 new
   tokens on 8 slots, max_seq 2048, page 16, chunk 128, ``decode_flash``:
   served paged (B1 with the ring's ``page_base`` on the 10 local layers,
   flat on the 2 global), paged with ``speculate_k`` 4 and the
   single-token drafter (verify spans at sq = 5 on a 66-page ring; once
   with the default pool, whose local group is exactly the 8 rings, and
   once with 2 scratch pages per slot beyond them), and from dense slots
   (B3 on the rolled window and the full cache); B1 / B3 launched steps
   x 12 exactly, the local group's peak pages within the rings (and the
   scratch); tokens/s, step and TTFT times, peak memory, each group's
   peak pages, the speculation counters beside the draftable steps of
   plain decode and token identity to the paged run printed; one decode
   step's logits through the kernels vs the plain path and its time
   split, paged and dense;
8. the moe family at full width — deepseek-v2-lite-16b (14 of its 27
   layers, MLA on latent pages, 64 experts top-6 plus 2 shared) and
   phi3.5-moe (full widths, 16 of its 32 layers: the whole model does
   not fit beside a KV pool), random bf16 weights from the seed, phase
   4's traffic served paged (phi3.5: B1 at a GQA group of 4) and from
   dense slots (phi3.5: B3), launches steps x 16 exactly; tokens/s,
   step and TTFT times, peak memory and pages, paged-vs-dense token
   identity as a share; one paged and one dense decode step each
   profiled (kernels per step, idle share, device time as attention
   kernel / matmul / MoE dispatch and combine / MLA glue / other), and
   phi3.5's step logits through the kernels vs the plain path (reported:
   top-k routing amplifies a one-ulp change); then the vlm and audio
   families at full width and depth through ``greedy_generate`` (the
   batcher refuses them, as the reference's does), bf16,
   ``decode_flash``: paligemma-3b two batches of 8 (256 bf16 patches of
   1152 + 64 / 128 text tokens, 64 new) and musicgen-medium one of 8
   (64 x 1536 conditioning rows, 8 frames of 4 codebooks, 256 new),
   max_seq 512; B3 launched steps x layers exactly; tokens/s (frames/s),
   prefill time, median decode step and peak memory; per model one
   decode step's logits through B3 vs the plain path (held) and its time
   split (attention kernel / matmul / cross-attention glue / other);
9. telemetry and sampling — at smoke width (fp32): telemetry off and on
   (tracing and ``torch.profiler`` ranges) give the same tokens on paged
   pools with the prefix cache and ``speculate_k`` 4, on dense slots
   (bf16, int8) and on int8 pages that preempt, B1 / B3 launched steps x
   layers and B2 exactly, the trace giving back the batcher's counters;
   the ``cuda`` generator's samples fixed by the seed and T 1e-6 equal to
   greedy; reserve-at-admission admitting 2 slots where lazy growth
   admits 8 at one pool, with the same tokens.  At full width (16 of
   its 32 layers since the sharded-training phase was added),
   minitron-4b's shared-prompt traffic paged with the prefix cache and
   ``speculate_k`` 4, served with telemetry off, then on (tokens/s
   of each; on: a live ``/metrics`` scrape that validates, with
   ``serve_steps_total`` equal to the steps, the trace giving back the
   counters, the decode-step histogram's p50 in the bucket of the
   host-timed median step), then a ``torch.profiler`` window in which
   each ``serve.*`` range counts its calls, B1 runs once a layer under
   each ``serve.decode_step`` and ``serve.verify`` range, and each kind's
   device ms per range is printed;
10. training — at smoke width (minitron-4b, fp32): the card's losses
   and gradient norms over 5 steps equal the port's CPU run to the CPU
   tests' tolerance, ``grad_accum`` 2 equals 1 (gradient norm to 1e-4,
   parameters to the reference's tolerance at an lr that moves them),
   ``TrainSupervisor`` with failures before steps 6 and 10 ends in the
   uninterrupted state bit for bit, a checkpoint round trip (bf16
   parameters) and remat none / dots / full change no bit; then
   minitron-4b at full width and depth (bf16 weights and gradients, fp32
   AdamW moments, remat dots), its memory reckoned first (a depth that
   does not fit is cut and printed, never a width), 4 steps at batch 1 x
   seq 1024 through ``launch.train.main``: per step wall ms, loss and
   gradient norm (finite), tokens/s, 6·N·tokens over the step time
   beside 989 TFLOP/s (N without the embedding table: a lookup does no
   matmul), peak memory and one profiled step's device time
   as matmul / blocked attention / optimizer / other.  Training launches
   no kernel of the port (none of the reference's Pallas kernels is on
   its path);
11. the roofline (budget 120 s) — ``launch.dryrun.run_cell`` for every
   (arch x shape) cell of ``dryrun.cells()`` at one H100, counted on fake
   CPU tensors in parallel processes (no kernel launched, nothing
   allocated on the card), one line per cell with its bound, bottleneck
   and ``mfu_bound``, every cell required to pass; then the full-width
   steps this run timed set beside the bound of their own count: the
   minitron-4b train step (b 1 x s 1024, counted on fake tensors), and
   the paged decode step, one 128-token prefill chunk and the dense
   decode step at 8 slots (each counted in one extra call on the card's
   real inputs, as their row masks depend on the data, B1 and B3 by
   their formula), each with its measured ms, the share and the card's
   name and power limit;
12. sharded training (budget 75 s) — one rank: a world-size-1 NCCL
   group from a ``HashStore`` (no port opened) and a (1, 1) ("data",
   "model") ``DeviceMesh("cuda")``; the port's tree and ring all-reduce
   and ``ppermute`` (no hop on one rank) and NCCL's all-reduce,
   all-gather and reduce-scatter give their input back bit for bit; then
   minitron-4b at phase 10's width and depth, from its seed and batches,
   3 steps through ``make_train_step(mesh=..., zero1=True)`` (parameters
   and ZeRO-1 moments as DTensors, the batch sharded over "data"), each
   step's loss and gradient norm and every parameter bit after the first
   (a per-leaf digest) equal to phase 10's unsharded steps; the sharded
   steps' wall ms and a profiled step's device busy ms beside the
   unsharded step's, with the card's name and power limit.  Multi-rank
   behaviour is held by the gloo tests on the CPU.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository around it, it exits non-zero and prints no result.
"""

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# every kernel of the port: its source and the TPU kernel it replaces.
KERNELS = {
    "flash_attention_decode_paged": (
        "src/repro_torch/csrc/flash_decode_paged.cu",
        "src/repro/kernels/flash_attention.py:523"),
    "flash_attention_decode": (
        "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention.py:322"),
    "kv_quantize": ("src/repro_torch/csrc/kv_quant.cu",
                    "src/repro/kernels/kv_quant.py:55"),
    "kv_quantize_store": ("src/repro_torch/csrc/kv_quant.cu",
                          "src/repro/kernels/kv_quant.py:55"),
    "kv_dequantize": ("src/repro_torch/csrc/kv_quant.cu",
                      "src/repro/kernels/kv_quant.py:76"),
    "stencil2d": ("src/repro_torch/csrc/stencil.cu",
                  "src/repro/kernels/stencil.py:68"),
    "tree_row_reduce": ("src/repro_torch/csrc/treereduce.cu",
                        "src/repro/kernels/treereduce_kernel.py:57"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm_kernel.py:37"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:153"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:88"),
}
# bf16 outputs: kernel and plain both accumulate in fp32 and round once,
# so an output may round to the neighbouring bf16 value: each element is
# held to TOL_BF16_ULPS ulps of the plain output plus TOL_BF16_FLOOR,
# which covers fp32 summation order (the f32 q cases differ by < 1e-6)
# where |out| is near 0.  fp32 outputs differ only by summation order
# over <= 4096 keys.
TOL_BF16_ULPS = 2
TOL_BF16_FLOOR = 1e-5
TOL_F32 = 1e-4
# fp32 RMSNorm: the sum of squares in another order than torch.mean.
TOL_RMS_F32 = 1e-5
# full-width logits (bf16 compute, 32 layers): one decode step through
# the kernel vs through the plain path, relative to the largest logit.
TOL_LOGITS_REL = 5e-2
# B6 against its twin: the JAX tests' rtol = atol = 2e-4 for the Pallas
# kernel (fp32, sums over up to 256 positions per chunk in another order).
TOL_SSD = (2e-4, 2e-4)
# the full-width train forward (b 4 x s 2048), fp32 compute with the bf16
# weights: logits through B6 vs through the plain scan, relative to the
# largest logit.  Readings: 3.5e-4 (mamba2) and 4.1e-4 (zamba2); the
# control, the plain scan at half the chunk (the same sums in another
# order), reads 2.4e-4 and 3.9e-4, so the limit sits 6-10x above both.
TOL_TRAIN_F32_REL = 2.5e-3
# the same forward in bf16 compute, where one-ulp roundings grow through
# 48 (38) random-weight layers: B6 vs plain is held to that control.
# Max error at most 2x the control's (readings 1.12x and 1.44x), argmax
# disagreement at most 1.5x the control's (readings 1.26x and 1.27x); a
# wrong scan leaves almost no argmax in place.
TOL_TRAIN_BF16_ERR_VS_CONTROL = 2.0
TOL_TRAIN_BF16_DISAGREE_VS_CONTROL = 1.5
# fp32 smoke-width logits with the scan through B6 vs through the plain
# chunked formula (the same sums in another order, through <= 12 layers).
TOL_SMOKE_LOGITS = 1e-3
# the library yardstick rounds scores/probabilities in bf16 inside its
# own kernel, so it is held to the plain version more loosely.
TOL_LIBRARY = 5e-2
# NVIDIA data sheets: HBM bandwidth (bytes/s) by H100 part; dense bf16
# tensor-core peak (operations/s) for the bf16 inputs the bound is
# computed for.
HBM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "": 3.35e12}
PEAK_BF16 = 989e12
# fp32 outside the tensor cores (the stencil's, reduction's and norm's
# adds and multiplies, and fp32 attention).
PEAK_F32 = 67e12


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE.items():
        if key and key in name:
            return rate
    return HBM_RATE[""]


def demangle(names):
    """C++ names as c++filt gives them (as they are without it)."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_entries(report: str):
    """[(kernel, registers, bytes of spill stores)] from ``-Xptxas -v``."""
    rows = []
    for chunk in report.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        rows.append((name, int(regs.group(1)) if regs else None,
                     int(spill.group(1)) if spill else 0))
    names = demangle([r[0] for r in rows])
    return [(n,) + r[1:] for n, r in zip(names, rows)]


def tensor_core_ops(lib) -> dict:
    """{kernel: count of HMMA/HGMMA instructions} in a built library's
    SASS (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"\bHG?MMA\.", chunk))
    return dict(zip(demangle(list(counts)), counts.values()))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at |x|, elementwise."""
    ax = x.float().abs().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


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
              ring=False, unallocated=False, min_pos=None):
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
    lo = max_pos // 8 if min_pos is None else min_pos
    pos = torch.randint(lo, max_pos - sq + 1, (b,), generator=gen,
                        device=dev).int()
    if unallocated:             # entries past each sequence's pages
        live = (pos.long() + sq - 1) // page
        cols = torch.arange(n_blocks, device=dev)[None, :]
        bt = torch.where(cols > live[:, None], n_pages + 7, bt).int()
    base = None
    if ring:        # the served rule: bases from the span's last row
        cur = (pos.long()[:, None] + sq - 1) // page
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
    """Pre-gathered contiguous K/V (b, hkv, S, d), dequantized to bf16
    for int8 pages, and the boolean (b, 1, sq, S) mask of the query rows
    at pos..pos+sq-1 (causal; the window band and the ring's key
    positions from ``page_base`` where the case has them), for the
    library yardstick."""
    kp, vp, bt = c["k_pages"], c["v_pages"], c["block_tab"].long()
    b, nb = bt.shape
    _, hkv, page, d = kp.shape
    S = nb * page

    def gather(pages, scales):
        x = pages[bt]
        if scales is not None:
            x = (x.float() * scales[bt].float()).bfloat16()
        return x.transpose(1, 2).reshape(b, hkv, S, d).contiguous()

    K = gather(kp, c["k_scale_pages"])
    V = gather(vp, c["v_scale_pages"])
    sq = c["q"].shape[2]
    qpos = c["pos"].long()[:, None] + torch.arange(sq, device=DEVICE)
    if c["page_base"] is not None:
        kpos = (c["page_base"].long()[:, :, None]
                + torch.arange(page, device=DEVICE)).reshape(b, S)
    else:
        kpos = torch.arange(S, device=DEVICE).expand(b, S)
    mask = kpos[:, None, :] <= qpos[:, :, None]
    if c["page_base"] is not None:
        mask &= (kpos >= 0)[:, None, :]
    if c["window"] is not None:
        mask &= kpos[:, None, :] > qpos[:, :, None] - c["window"]
    return K, V, mask[:, None]


def hold(tag, name, out, ref, rule):
    """A kernel's output against its plain twin's: ``rule`` is "bit" (bit
    for bit), "bf16" (TOL_BF16_ULPS ulps of |plain| + TOL_BF16_FLOOR per
    element), (rtol, atol) or an absolute tolerance.  Returns the row's
    error fields."""
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{tag} [{name}]: {tuple(out.shape)} {out.dtype} != plain's "
          f"{tuple(ref.shape)} {ref.dtype}")
    if rule == "bits":        # the same bits: -0.0 apart from 0.0, NaN too
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        same = out.view(ints[out.dtype]) == ref.view(ints[ref.dtype])
        check(bool(same.all()), f"{tag} vs plain [{name}]: not bit-equal "
              f"({int((~same).sum())} values differ)")
        return {"max_abs_err": 0.0, "tol": "bit-exact"}
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if rule == "bit":
        check(torch.equal(out, ref), f"{tag} vs plain [{name}]: not "
              f"bit-equal ({int((out != ref).sum())} values differ, max abs "
              f"err {err})")
        return {"max_abs_err": err, "tol": "bit-exact"}
    if rule == "bf16":
        tol = f"{TOL_BF16_ULPS} bf16 ulp of |plain| + {TOL_BF16_FLOOR}"
        limit = TOL_BF16_ULPS * bf16_ulp(ref) + TOL_BF16_FLOOR
    elif isinstance(rule, tuple):
        rtol, atol = rule
        tol = f"rtol {rtol}, atol {atol}"
        limit = atol + rtol * ref.float().abs()
    else:
        tol, limit = rule, torch.full_like(diff, rule)
    ratio = (diff / limit).max().item()
    check(ratio <= 1.0, f"{tag} vs plain [{name}]: max abs err {err}, "
          f"{ratio:.3g}x the tolerance ({tol})")
    return {"max_abs_err": err, "tol": tol, "err_over_tol": ratio}


def hold_attention(tag, kernel, plain, make, cases, yardstick, bound,
                   flush, info=None):
    """Hold a decode-attention kernel against its plain twin for every
    case; time the "main" and "long" cases beside their bound and one
    SDPA call, the library yardstick (the port never calls it).
    ``yardstick(c)`` -> (args, kwargs, note) of that call, its inputs
    prepared beforehand and not timed; ``bound(c)`` -> dict; ``info(c)``
    -> dict of more fields for every case's row."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for name, kw in cases.items():
        c = make(**kw)
        out = kernel(**c)
        torch.cuda.synchronize()
        ref = plain(**c)
        row = hold(tag, name, out, ref,
                   TOL_F32 if c["q"].dtype == torch.float32 else "bf16")
        if info is not None:
            row.update(info(c))
        if name.startswith(("main", "long")):
            row["ms"] = time_ms(lambda: kernel(**c), flush)
            row["plain_ms"] = time_ms(lambda: plain(**c), flush)
            args, kwargs, row["library"] = yardstick(c)
            lib = sdpa(*args, **kwargs)
            lib_err = (lib.float() - ref.float()).abs().max().item()
            check(lib_err <= TOL_LIBRARY,
                  f"{tag} library yardstick disagrees [{name}]: {lib_err}")
            row["library_ms"] = time_ms(lambda: sdpa(*args, **kwargs), flush)
            row.update(bound(c))
            del args, kwargs, lib
        results[name] = row
        print(f"{tag} vs plain [{name}]: " + json.dumps(row))
        del c, out, ref
    torch.cuda.empty_cache()
    return results


# B1 at gemma3-12b's local layers, as its paged serve reads them.
GEMMA3_LOCAL = dict(b=8, hq=16, hkv=8, d=256, n_blocks=65, window=1024,
                    ring=True, min_pos=1100, max_pos=1561)


def phase_kernel(gen, card, flush):
    """B1 vs its plain twin; timings at the main and long shapes."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_decode_paged as kernel,
        flash_attention_decode_paged_plain as plain, paged_splits)
    main = dict(b=8, n_blocks=64, max_pos=1024)
    cases = {
        "main (8 seqs, pos <= 1k, bf16)": main,
        "long (32 seqs x 4096 pos, bf16)": dict(b=32, n_blocks=256,
                                                max_pos=4096),
        "sq=4 verify span": dict(main, sq=4),
        # the served verify span: speculate_k 4 drafts + the last token.
        "main verify (8 seqs, sq=5, pos <= 1k, bf16)": dict(main, sq=5),
        "main verify (8 seqs, sq=5, pos <= 1k, int8 + bf16 scales)": dict(
            main, sq=5, quant=True),
        # phi3.5-moe's served shapes: 32 / 8 heads of 128 (a GQA group of
        # 4), decode and the verify span (20 rows per sequence and kv head).
        "main phi3.5 decode (8 seqs, hq 32 / hkv 8, d 128, pos <= 1k, "
        "bf16)": dict(main, hq=32),
        "main phi3.5 verify (8 seqs, sq=5, hq 32 / hkv 8, d 128, pos <= 1k, "
        "bf16)": dict(main, hq=32, sq=5),
        "phi3.5 decode, int8 + bf16 scales": dict(main, hq=32, quant=True),
        "window=256": dict(main, window=256),
        "ring page_base, window=100": dict(
            main, n_blocks=-(-100 // 16) + 1, window=100, ring=True),
        "int8 + bf16 scales": dict(main, quant=True),
        "f32 q": dict(main, q_dtype=torch.float32),
        "table entries >= n_pages": dict(main, unallocated=True),
        # the split-KV edges: many splits on one sequence, splits with no
        # live key, int8 and verify rows with splits, one split (a ring
        # of one tile), and a tile of five 12-key pages (int8 scales then
        # copied by plain loads, not cp.async).
        "1 seq x 4096 pos (many splits)": dict(b=1, n_blocks=256,
                                               max_pos=4096),
        "pos < one tile (splits with no live key)": dict(main, max_pos=40),
        "int8, 1 seq x 4096 pos (many splits)": dict(
            b=1, n_blocks=256, max_pos=4096, quant=True),
        "sq=4, 1 seq x 4096 pos (many splits)": dict(
            b=1, n_blocks=256, max_pos=4096, sq=4),
        "ring page_base, window=48 (one tile, n_split 1)": dict(
            main, n_blocks=4, window=48, ring=True),
        "int8, page 12": dict(main, page=12, n_blocks=86, quant=True),
        # gemma3-12b's served shapes: 16 / 8 heads of 256; the local
        # layers read a ring of 65 pages (66 with speculate_k 4, the
        # verify span's) under a 1024 window at positions past the wrap,
        # the global layers a flat table of 2048 positions.
        "main gemma3 local decode (8 seqs, d 256, ring of 65 pages, "
        "window 1024, pos 1100-1560, bf16)": GEMMA3_LOCAL,
        "main gemma3 local verify (8 seqs, sq=5, d 256, ring of 66 pages, "
        "window 1024, pos 1100-1560, bf16)": dict(GEMMA3_LOCAL, sq=5,
                                                   n_blocks=66),
        "main gemma3 global decode (8 seqs, d 256, 128 pages, pos "
        "1100-1560, bf16)": dict(GEMMA3_LOCAL, n_blocks=128, window=None,
                                  ring=False),
        "gemma3 local decode, int8 + bf16 scales": dict(GEMMA3_LOCAL,
                                                        quant=True),
        "gemma3 local verify, sq=5, int8 + bf16 scales": dict(
            GEMMA3_LOCAL, sq=5, n_blocks=66, quant=True),
        "gemma3 local verify, sq=5, before the wrap": dict(
            GEMMA3_LOCAL, sq=5, n_blocks=66, min_pos=0, max_pos=1100),
    }

    def yardstick(c):
        K, V, mask = sdpa_inputs(c)
        return ((c["q"], K, V), dict(attn_mask=mask, enable_gqa=True),
                "sdpa on pre-gathered K/V (int8 dequantized), gather "
                "excluded")

    def bound(c):
        ms, by = bound_ms(c, card)
        return {"bound_ms": ms, "bound_by": by, "live_pages": live_pages(c)}

    def info(c):
        b, hq, _, _ = c["q"].shape
        _, hkv, page, _ = c["k_pages"].shape
        return {"n_split": paged_splits(
            b, hkv, c["block_tab"].shape[1], page,
            torch.cuda.get_device_properties(0).multi_processor_count)}

    return hold_attention("B1", kernel, plain, lambda **kw: make_case(
        gen, **kw), cases, yardstick, bound, flush, info)


def make_dense_case(gen, *, b=8, hq=24, hkv=8, d=128, S=1024, pos=None,
                    max_pos=1024, q_dtype=torch.bfloat16, window=None,
                    ring=False):
    """Inputs of the dense-slot kernel: caches in q's dtype (the layer
    casts the cache to q's dtype first), positions drawn in
    [max_pos // 8, max_pos) unless given."""
    dev = DEVICE
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(q_dtype)
    k, v = (torch.randn((b, hkv, S, d), generator=gen, device=dev).to(q_dtype)
            for _ in range(2))
    if pos is None:
        pos = torch.randint(max_pos // 8, max_pos, (b,), generator=gen,
                            device=dev)
    else:
        pos = torch.as_tensor(pos, device=dev)
    return dict(q=q, k=k, v=v, pos=pos.int().contiguous(), window=window,
                ring=ring)


def dense_valid(c):
    """(b, S) keys the kernel must attend (the reference's rule)."""
    S = c["k"].shape[2]
    kpos = torch.arange(S, device=DEVICE)[None, :]
    p = c["pos"].long()[:, None]
    if c["ring"]:
        return (kpos <= p) | (p >= c["window"])
    valid = kpos <= p
    if c["window"] is not None:
        valid &= kpos > p - c["window"]
    return valid


def dense_bound_ms(c, card: str):
    """Least time: the live K/V rows read once, q read, out written."""
    q, k = c["q"], c["k"]
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    live = int(dense_valid(c).sum())          # live keys over sequences
    nbytes = (live * hkv * d * k.element_size() * 2
              + 2 * q.numel() * q.element_size() + b * 4)
    ops = 4.0 * (hq // hkv) * d * live * hkv
    t_bytes = nbytes / hbm_rate(card) * 1e3
    t_ops = ops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_dense_kernel(gen, card, flush):
    """B3 vs its plain twin; timings at the main and long shapes."""
    from repro_torch.kernels.flash_attention import (
        dense_splits, flash_attention_decode as kernel,
        flash_attention_decode_plain as plain)
    ring_pos = [10, 100, 255, 256, 300, 1000, 4000, 200]
    cases = {
        "main (8 slots x 1024, pos 128-1023, bf16)": {},
        # phi3.5-moe's dense slots: 32 / 8 heads of 128, a group of 4.
        "main phi3.5 (8 slots x 1024, hq 32 / hkv 8, d 128, pos 128-1023, "
        "bf16)": dict(hq=32),
        "long (32 slots x 4096, bf16)": dict(b=32, S=4096, max_pos=4096),
        "f32 q": dict(q_dtype=torch.float32),
        "band window=256": dict(window=256),
        "ring S=window=256": dict(S=256, window=256, ring=True,
                                  pos=ring_pos),
        "per-row positions": dict(pos=[0, 1, 63, 64, 65, 511, 1022, 1023]),
        "zamba2 widths (MHA, 32 heads of 64, group 1)": dict(hq=32, hkv=32,
                                                             d=64),
        # the split-KV edges: a split per tile, splits with no live key,
        # positions at and past S (a finished slot), band and ring with
        # splits, zamba2's widths and fp32 with splits, fp32 at d = 256
        # (the kernel halves its tile there).
        "1 slot x 4096, hkv 4 (n_split = tile count)": dict(
            b=1, hkv=4, S=4096, pos=[4095]),
        "positions 0 and 1 (most splits empty)": dict(pos=[0, 1] * 4),
        "pos >= S": dict(pos=[1023, 1024, 1500, 99999, 2000, 4096, 1024,
                              5000]),
        "band window=700, 2 slots x 4096": dict(b=2, S=4096, window=700,
                                                pos=[3000, 4095]),
        "ring S=window=2048, 2 slots (one wrapped)": dict(
            b=2, S=2048, window=2048, ring=True, pos=[5000, 100]),
        "zamba2 widths, 1 slot x 4096": dict(b=1, hq=32, hkv=32, d=64,
                                            S=4096, pos=[4000]),
        "f32 q, 2 slots x 4096": dict(b=2, S=4096, max_pos=4096,
                                      q_dtype=torch.float32),
        "f32 q, d 256, group 8 (half tiles)": dict(b=2, hq=8, hkv=1, d=256,
                                                  S=300, pos=[299, 150],
                                                  q_dtype=torch.float32),
        # gemma3-12b's served shapes, bf16 at d 256: the local layers'
        # rolled ring (S == window == 1024, positions past the wrap), the
        # global layers' flat 2048.
        "main gemma3 local (8 slots, d 256, ring S=window=1024, pos "
        "1100-1560, bf16)": dict(hq=16, hkv=8, d=256, S=1024, window=1024,
                                 ring=True, pos=[1100, 1560, 1234, 1301,
                                                 1455, 1112, 1499, 1387]),
        "main gemma3 global (8 slots, d 256, S 2048, pos 1100-1560, bf16)":
            dict(hq=16, hkv=8, d=256, S=2048,
                 pos=[1100, 1560, 1234, 1301, 1455, 1112, 1499, 1387]),
        "gemma3 local ring, positions before and at the wrap": dict(
            hq=16, hkv=8, d=256, S=1024, window=1024, ring=True,
            pos=[0, 1, 700, 1022, 1023, 1024, 1025, 2047]),
        # the vlm and audio families' served shapes (phase_vlm_audio_*):
        # paligemma-3b, MQA with a group of 8 over one kv head of 256,
        # 256 patches + 64 or 128 text tokens + 64 new; musicgen-medium,
        # MHA (group 1) at d 64, 8 frames + 256 new.
        "main paligemma (8 slots, hq 8 / hkv 1, d 256, S 512, pos "
        "320-447, bf16)": dict(hq=8, hkv=1, d=256, S=512,
                               pos=[320, 447, 383, 384, 351, 416, 329, 440]),
        "main musicgen (8 slots, hq 24 / hkv 24, d 64, S 512, pos 8-263, "
        "bf16)": dict(hq=24, hkv=24, d=64, S=512,
                      pos=[8, 263, 135, 136, 71, 200, 9, 250]),
    }

    def yardstick(c):
        g = c["q"].shape[1] // c["k"].shape[1]
        K = c["k"].repeat_interleave(g, dim=1)
        V = c["v"].repeat_interleave(g, dim=1)
        return ((c["q"], K, V), dict(attn_mask=dense_valid(c)[:, None, None]),
                "sdpa on K/V expanded to hq heads, not timed")

    def bound(c):
        ms, by = dense_bound_ms(c, card)
        return {"bound_ms": ms, "bound_by": by,
                "live_keys": int(dense_valid(c).sum())}

    def info(c):
        b, _, _, _ = c["q"].shape
        _, hkv, S, _ = c["k"].shape
        return {"n_split": dense_splits(
            b, hkv, S,
            torch.cuda.get_device_properties(0).multi_processor_count)}

    return hold_attention("B3", kernel, plain, lambda **kw: make_dense_case(
        gen, **kw), cases, yardstick, bound, flush, info)


def quant_bound_ms(rows: int, d: int, in_bytes: int, out_bytes: int,
                   card: str):
    """Least time of a quantize (in x, out int8 + bf16 scale) or
    dequantize (in int8 + scale, out x): bytes over the HBM rate."""
    return (rows * d * (in_bytes + out_bytes) + rows * 2) / hbm_rate(
        card) * 1e3, "bytes"


def phase_quant_kernel(gen, card, flush):
    """B2 vs its plain twins, bit for bit; timings at the main path's
    shapes: decode rows (one new K or V row per slot and kv head), a
    prefill chunk, and the full slot cache (read back every step)."""
    from repro_torch.kernels.kv_quant import (
        kv_dequantize, kv_dequantize_plain, kv_quantize, kv_quantize_plain)
    d = 128
    ties = torch.tensor([2.5, -3.5, 0.5, 1.5, -0.5, 127.0, 4.5, -126.5]
                        * (d // 8), device=DEVICE)
    cases = {
        "decode rows (8*8*1 x 128, bf16)": (8 * 8, torch.bfloat16),
        "decode rows (8*8*1 x 128, f32)": (8 * 8, torch.float32),
        "prefill chunk (8*128*8 x 128, bf16)": (8 * 128 * 8, torch.bfloat16),
        "full cache (8*8*1024 x 128, bf16)": (8 * 8 * 1024, torch.bfloat16),
        "zero rows (64 x 128, bf16)": (64, torch.bfloat16),
        "exact .5 quotients (64 x 128, f32)": (64, torch.float32),
    }
    results = {}
    for name, (rows, dt) in cases.items():
        x = (torch.randn((rows, d), generator=gen, device=DEVICE)
             * torch.rand((rows, 1), generator=gen, device=DEVICE) * 8)
        if name.startswith("zero"):
            x.zero_()
        if name.startswith("exact"):
            x[:] = ties                      # amax 127: scale exactly 1
        x = x.to(dt)
        q, s = kv_quantize(x)
        torch.cuda.synchronize()
        pq, ps = kv_quantize_plain(x)
        errs = [(q.int() - pq.int()).abs().max().item(),
                (s.float() - ps.float()).abs().max().item()]
        check(torch.equal(q, pq) and torch.equal(s, ps),
              f"B2 quantize vs plain [{name}]: not bit-equal "
              f"({int((q != pq).sum())} values, {int((s != ps).sum())} "
              f"scales differ)")
        if name.startswith("exact"):
            check(q[0, :8].tolist() == [2, -4, 0, 2, 0, 127, 4, -126],
                  f"B2 rounding is not half-to-even: {q[0, :8].tolist()}")
        for out_dt in (torch.bfloat16, torch.float32):
            o = kv_dequantize(q, s, out_dt)
            torch.cuda.synchronize()
            po = kv_dequantize_plain(q, s, out_dt)
            errs.append((o.float() - po.float()).abs().max().item())
            check(torch.equal(o, po), f"B2 dequantize vs plain [{name}, "
                  f"{out_dt}]: not bit-equal")
        row = {"max_abs_err": max(errs), "tol": "bit-exact"}
        if "zero" not in name and "exact" not in name:
            row["quantize_ms"] = time_ms(lambda: kv_quantize(x), flush)
            row["quantize_plain_ms"] = time_ms(lambda: kv_quantize_plain(x),
                                               flush)
            row["quantize_bound_ms"], row["bound_by"] = quant_bound_ms(
                rows, d, x.element_size(), 1, card)
            row["dequantize_ms"] = time_ms(
                lambda: kv_dequantize(q, s, dt), flush)
            row["dequantize_plain_ms"] = time_ms(
                lambda: kv_dequantize_plain(q, s, dt), flush)
            row["dequantize_bound_ms"], _ = quant_bound_ms(
                rows, d, 1, x.element_size(), card)
            row["quantize_library"] = "no single PyTorch call"
            if dt == torch.bfloat16:
                # one call computes the bf16 dequantize: int8 * bf16
                # promotes to bf16, multiplies in fp32 and rounds once.
                lib = q * s
                check(lib.dtype == torch.bfloat16 and torch.equal(
                    lib, kv_dequantize_plain(q, s, dt)),
                    f"B2 dequantize library yardstick q * s [{name}] is "
                    "not bit-equal to the plain version")
                row["dequantize_library"] = "q * s, bf16 out (never " \
                    "called by the port)"
                row["dequantize_library_ms"] = time_ms(lambda: q * s, flush)
                del lib
        results[name] = row
        print(f"B2 vs plain [{name}]: " + json.dumps(row))
    torch.cuda.empty_cache()
    return results


def store_bound_ms(n: int, kept: int, d: int, in_bytes: int, card: str):
    """Least time of a ``kv_quantize_store``: n K rows and n V rows read,
    their int64 destination rows read once, and the int8 values and bf16
    scales of the ``kept`` rows (of each) written."""
    return (2 * n * d * in_bytes + n * 8 + 2 * kept * (d + 2)) / hbm_rate(
        card) * 1e3, "bytes"


def make_store_case(gen, layout, *, d=128, dtype=torch.bfloat16,
                    ties=False):
    """One layer's K/V rows and the cache leaves they land in, at the
    full-width path's shapes: 8 slots x 8 kv heads into a dense slot
    cache of 1024 positions (slots in range, on a ring, clamped to S - 1)
    or a pool of 8 x 64 pages of 16 (a decode step with one slot
    inactive, or one slot's prefill chunk of 128 with a padded tail).
    Returns (k, v, leaves, dst_row, the separate route's cache write)."""
    from repro_torch.models import layers
    from repro_torch.kernels.kv_quant import kv_store_rows
    dev, b, hkv = DEVICE, 8, 8
    if layout.startswith("paged"):
        page, nb = 16, 64
        n_pages = b * nb
        lead = (n_pages, hkv, page, d)
        bt = torch.randperm(n_pages, generator=gen, device=dev).reshape(
            b, nb).int()
        if layout == "paged chunk":
            s, rows_b = CHUNK, 1
            pos = torch.full((1,), 256, device=dev)
            bt, last = bt[:1], torch.full((1,), 100, device=dev)
        else:
            s, rows_b = 1, b
            pos = torch.randint(100, 900, (b,), generator=gen, device=dev)
            bt[b - 1] = n_pages                      # an inactive slot
            last = None
        args = (bt, pos, s, page, n_pages)
        dst = layers.paged_store_rows(*args, hkv, last)
        rb, rs, wp, wo = layers.paged_write_index(*args, last)
        shape = (rows_b, s, hkv, d)

        def route_write(leaves, new):
            for name, t in new.items():
                leaves[name][wp, :, wo] = t[rb, rs]
    else:
        S = 1024
        lead = (b, hkv, S, d)
        pos = torch.randint(100, 900, (b,), generator=gen, device=dev)
        if layout == "dense ring":
            pos = pos + 3 * S
            slot = pos % S
        else:
            pos = pos + (S if layout == "dense clamped" else 0)
            slot = pos.clamp(max=S - 1)
        ar = torch.arange(b, device=dev)
        dst = kv_store_rows(ar, slot, hkv, S)
        shape = (b, hkv, d)

        def route_write(leaves, new):
            for name, t in new.items():
                leaves[name][ar, :, slot] = t
    leaves = {n: torch.randint(-127, 128, lead, generator=gen, device=dev,
                               dtype=torch.int8) for n in "kv"}
    leaves.update({n + "_scale": torch.rand(
        lead[:-1] + (1,), generator=gen, device=dev).bfloat16() for n in "kv"})
    k, v = ((torch.randn(shape, generator=gen, device=dev)
             * torch.rand(shape[:-1] + (1,), generator=gen, device=dev) * 8)
            for _ in range(2))
    if ties:
        k[:] = v[:] = torch.tensor([2.5, -3.5, 0.5, 1.5, -0.5, 127.0, 4.5,
                                    -126.5] * (d // 8), device=dev)
    return k.to(dtype), v.to(dtype), leaves, dst.contiguous(), route_write


def phase_store_kernel(gen, card, flush):
    """B2's quantize-and-store entry vs its plain twin, every cache leaf
    bit for bit after the store, at the full-width path's shapes (dense
    slots in range, on a ring and clamped; a paged decode step with an
    inactive slot; a paged prefill chunk with a padded tail; fp32 rows;
    .5 quotients); timed beside its bound and beside the separate route
    (two ``kv_quantize`` launches, then the indexed writes of the four
    leaves, as the model wrote an int8 cache before the store) on the
    same inputs."""
    from repro_torch.kernels.kv_quant import (
        kv_quantize, kv_quantize_store, kv_quantize_store_plain)
    cases = {
        "dense decode rows (8 slots x 8 kv heads, K and V, d 128, bf16)":
            dict(layout="dense"),
        "dense ring slots (bf16)": dict(layout="dense ring"),
        "dense slots clamped to S - 1 (f32)": dict(layout="dense clamped",
                                                   dtype=torch.float32),
        "paged decode rows, one slot inactive (bf16)": dict(layout="paged"),
        "paged prefill chunk (1 x 128 tokens x 8 kv heads, padded tail, "
        "bf16)": dict(layout="paged chunk"),
        "dense decode rows d 64 (f32)": dict(layout="dense", d=64,
                                            dtype=torch.float32),
        "dense decode rows d 256 (bf16)": dict(layout="dense", d=256),
        "exact .5 quotients (dense, f32)": dict(layout="dense",
                                                dtype=torch.float32,
                                                ties=True),
    }
    timed = ("dense decode rows (8", "paged decode", "paged prefill")
    results = {}
    for name, kw in cases.items():
        k, v, leaves, dst, route_write = make_store_case(gen, **kw)
        twin = {n: t.clone() for n, t in leaves.items()}

        def store(leaves=leaves):
            kv_quantize_store(k, v, leaves["k"], leaves["v"],
                              leaves["k_scale"], leaves["v_scale"], dst)

        def plain(leaves=twin):
            kv_quantize_store_plain(k, v, leaves["k"], leaves["v"],
                                    leaves["k_scale"], leaves["v_scale"],
                                    dst)

        store()
        torch.cuda.synchronize()
        plain()
        differ = {n: int((leaves[n] != twin[n]).sum()) for n in leaves}
        check(not any(differ.values()), f"B2 store vs plain [{name}]: not "
              f"bit-equal ({differ} values differ)")
        if kw.get("ties"):
            q = leaves["k"].view(-1, k.shape[-1])[dst.reshape(-1)[0], :8]
            check(q.tolist() == [2, -4, 0, 2, 0, 127, 4, -126],
                  f"B2 store rounding is not half-to-even: {q.tolist()}")
        n = k.numel() // k.shape[-1]
        kept = int((dst >= 0).sum())
        row = {"max_abs_err": 0.0, "tol": "bit-exact", "rows": n,
               "kept": kept}
        if name.startswith(timed):
            def route(leaves=leaves):
                qk, sk = kv_quantize(k.reshape(-1, k.shape[-1]))
                qv, sv = kv_quantize(v.reshape(-1, v.shape[-1]))
                route_write(leaves, {
                    "k": qk.view(k.shape), "v": qv.view(v.shape),
                    "k_scale": sk.view(k.shape[:-1] + (1,)),
                    "v_scale": sv.view(v.shape[:-1] + (1,))})

            row["ms"] = time_ms(store, flush)
            row["plain_ms"] = time_ms(plain, flush)
            row["separate_route_ms"] = time_ms(route, flush)
            row["bound_ms"], row["bound_by"] = store_bound_ms(
                n, kept, k.shape[-1], k.element_size(), card)
            row["library_ms"] = None
        results[name] = row
        print(f"B2 store vs plain [{name}]: " + json.dumps(row))
        del k, v, leaves, twin, dst
    torch.cuda.empty_cache()
    return results


# --- phase 2, continued: the hlslib kernels (B8, B7, B4, B5) ---------------------------


def run_case(tag, name, kernel, plain, rule, flush, bound=None,
             library=None, info=None):
    """Hold ``kernel()`` against ``plain()``; with ``bound`` (a dict of
    bound_ms and bound_by) also time both beside it and beside
    ``library`` = (call, note), one PyTorch call held loosely to the
    plain output and never called by the port.  ``info``: more fields
    for the row."""
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    row = hold(tag, name, out, ref, rule)
    row.update(info or {})
    if bound is not None:
        row["ms"] = time_ms(kernel, flush)
        row["plain_ms"] = time_ms(plain, flush)
        row.update(bound)
        row["library_ms"] = None
        if library is not None:
            call, row["library"] = library
            lib = call()
            lib_err = (lib.float() - ref.float()).abs().max().item()
            check(lib_err <= TOL_LIBRARY, f"{tag} library yardstick "
                  f"disagrees [{name}]: {lib_err}")
            row["library_err"] = lib_err
            row["library_ms"] = time_ms(call, flush)
            del lib
    print(f"{tag} vs plain [{name}]: " + json.dumps(row))
    del out, ref
    return row


def bound_of(nbytes: float, ops: float, peak: float, card: str):
    """{bound_ms, bound_by}: the larger of bytes over the HBM rate and
    operations over ``peak``."""
    t_bytes = nbytes / hbm_rate(card) * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps, per (batch, q head)."""
    qpos = torch.arange(sq, dtype=torch.int64) + (sk - sq)
    hi = qpos.clamp(max=sk - 1) if causal else torch.full_like(qpos, sk - 1)
    lo = (qpos - window + 1).clamp(min=0) if window else torch.zeros_like(qpos)
    return int((hi - lo + 1).clamp(min=0).sum())


def make_attention(gen, *, b=8, hq=24, hkv=8, sq=512, sk=512, d=128,
                   dtype=torch.bfloat16):
    return [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def attention_bound(q, k, causal, window, card):
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops = 4.0 * d * attention_pairs(sq, sk, causal, window) * b * hq
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_F32
    return bound_of(nbytes, ops, peak, card)


def phase_hlslib_kernels(gen, card, flush):
    """B8, B7, B4 and B5 against their plain twins on the card; timings at
    the main and long shapes.  Returns {kernel: {case: row}}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm_kernel as rk
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels import treereduce_kernel as tk
    F = torch.nn.functional
    res = {"stencil2d": {}, "tree_row_reduce": {}, "rmsnorm": {},
           "flash_attention": {}}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    # B8: one sweep, bit for bit; library = the 3x3 cross as a conv2d.
    for name, (H, W, dt, timed) in {
            "main (16384 x 16384 fp32)": (16384, 16384, torch.float32, True),
            "4096 x 4096 bf16": (4096, 4096, torch.bfloat16, False),
            "W % 4 != 0 (999 x 1001 fp32)": (999, 1001, torch.float32, False),
            "33 x 128 fp32": (33, 128, torch.float32, False),
            "one row (1 x 7 fp32)": (1, 7, torch.float32, False)}.items():
        x = randn(H, W, dtype=dt)
        bound = library = None
        if timed:
            n = x.numel()
            bound = bound_of(2 * n * x.element_size(), 4 * n, PEAK_F32, card)
            cross = torch.tensor([[0, .25, 0], [.25, 0, .25], [0, .25, 0]],
                                 device=DEVICE).reshape(1, 1, 3, 3)
            library = (lambda: F.conv2d(x[None, None], cross, padding=1)[0, 0],
                       "F.conv2d, 3x3 cross, padding 1, TF32 off")
        res["stencil2d"][name] = run_case(
            "B8", name, lambda: st.stencil2d(x), lambda: st.stencil2d_plain(x),
            "bit", flush, bound, library)
        del x, library
    torch.cuda.empty_cache()

    # B7: bit for bit (by the bits: -0.0 and NaN too); library =
    # torch.sum / torch.amax over the rows.  Both regimes (a warp per row;
    # few long rows split over CTAs) and every vector edge: N = 2^k + 1,
    # rows that break 16-byte alignment, an unaligned start, -0.0 rows for
    # add, +-inf, NaN and +-0.0 rows for max.
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (op, rows, n, dt, timed, *fill) in {
            "main add (32768 x 4096 fp32)":
                ("add", 32768, 4096, torch.float32, True),
            "main max (32768 x 4096 fp32)":
                ("max", 32768, 4096, torch.float32, True),
            "long add (16 x 256000 fp32, vocab-wide logit rows)":
                ("add", 16, 256000, torch.float32, True),
            "long max (16 x 256000 fp32, vocab-wide logit rows)":
                ("max", 16, 256000, torch.float32, True),
            "add (7 x 1000 bf16)": ("add", 7, 1000, torch.bfloat16, False),
            "max (100 x 300 fp32)": ("max", 100, 300, torch.float32, False),
            "add (3 x 5 fp32)": ("add", 3, 5, torch.float32, False),
            "max (5 x 1 fp32)": ("max", 5, 1, torch.float32, False),
            "long add (16 x 256000 bf16)":
                ("add", 16, 256000, torch.bfloat16, False),
            "one row of 2^24 fp32": ("add", 1, 1 << 24, torch.float32, False),
            "n = 2^20 + 1 (3 rows fp32, split, scalar loads)":
                ("add", 3, (1 << 20) + 1, torch.float32, False),
            "n = 2^12 + 1 (5 x 4097 bf16)":
                ("add", 5, 4097, torch.bfloat16, False),
            "unaligned rows (7 x 1001 bf16)":
                ("add", 7, 1001, torch.bfloat16, False),
            "unaligned rows, max (9 x 1003 fp32)":
                ("max", 9, 1003, torch.float32, False),
            "unaligned start (6 x 4096 fp32 at offset 4 bytes)":
                ("add", 6, 4096, torch.float32, False, "offset"),
            "-0.0 row, add (4 x 65536 fp32, split)":
                ("add", 4, 65536, torch.float32, False, "neg-zero"),
            "-0.0 row, add (4 x 1000 fp32, padded)":
                ("add", 4, 1000, torch.float32, False, "neg-zero"),
            "+-inf and NaN rows, max (16 x 256000 fp32, split)":
                ("max", 16, 256000, torch.float32, False, "inf"),
            "+-inf and NaN rows, max (4 x 4096 bf16)":
                ("max", 4, 4096, torch.bfloat16, False, "inf"),
            "+-0.0 rows, max (4 x 1000 fp32)":
                ("max", 4, 1000, torch.float32, False, "signed-zero"),
            "+-0.0 rows, max (4 x 65536 fp32, split)":
                ("max", 4, 65536, torch.float32, False, "signed-zero")
            }.items():
        if fill == ["offset"]:
            x = randn(rows * n + 1)[1:].view(rows, n)
        else:
            x = randn(rows, n)
            if fill == ["neg-zero"]:
                x[0] = -0.0
            elif fill == ["inf"]:
                x[0, ::7] = float("inf")
                x[1] = float("-inf")
                x[2, n // 2] = float("nan")
            elif fill == ["signed-zero"]:
                x[0, ::2] = 0.0
                x[0, 1::2] = -0.0
                x[1] = -0.0
            x = x.to(dt)
        bound = library = None
        if timed:
            bound = bound_of((x.numel() + rows) * x.element_size(), x.numel(),
                             PEAK_F32, card)
            if op == "max":
                check(torch.equal(torch.amax(x, -1),
                                  tk.tree_row_reduce_plain(x, op)),
                      f"B7 [{name}]: torch.amax is not bit-equal to plain")
                library = (lambda: torch.amax(x, -1),
                           "torch.amax (bit-equal to plain)")
            else:
                library = (lambda: torch.sum(x, -1), "torch.sum")
        res["tree_row_reduce"][name] = run_case(
            "B7", name, lambda: tk.tree_row_reduce(x, op),
            lambda: tk.tree_row_reduce_plain(x, op), "bits", flush, bound,
            library, {"n_split": tk.tree_splits(rows, n, n_sm)})
        del x, library
    torch.cuda.empty_cache()

    # B4: library = F.rms_norm with the (1 + w) gains formed beforehand.
    for name, (rows, d, dt, timed) in {
            "main (4096 x 3072 bf16, 8 prompts x 512 tokens)":
                (4096, 3072, torch.bfloat16, True),
            "decode rows (8 x 3072 bf16)": (8, 3072, torch.bfloat16, True),
            "fp32 (4096 x 3072)": (4096, 3072, torch.float32, False),
            "d % 4 != 0 (5 x 100 fp32)": (5, 100, torch.float32, False),
            "d % 8 != 0 (300 x 3071 bf16)": (300, 3071, torch.bfloat16,
                                             False),
            "wide (16 x 16384 fp32, two passes)": (16, 16384, torch.float32,
                                                   False)
            }.items():
        x = randn(rows, d, dtype=dt)
        w = (randn(d) * 0.1).to(dt)
        bound = library = None
        if timed:
            bound = bound_of((2 * x.numel() + d) * x.element_size(),
                             4 * x.numel(), PEAK_F32, card)
            w1 = (1.0 + w.float()).to(dt)
            library = (lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6),
                       "F.rms_norm, weight 1 + w formed beforehand")
        wpr, rpc = rk.rmsnorm_plan(rows, d, x.element_size(), n_sm)
        res["rmsnorm"][name] = run_case(
            "B4", name, lambda: rk.rmsnorm(x, w), lambda: rk.rmsnorm_plain(x, w),
            "bf16" if dt == torch.bfloat16 else TOL_RMS_F32, flush, bound,
            library, {"warps_per_row": wpr, "rows_per_cta": rpc})
        del x, w, library
    torch.cuda.empty_cache()

    # B5: library = SDPA (its is_causal aligns top-left, so only sq == sk
    # without a window may use it; other masks are bottom-right aligned).
    sdpa = F.scaled_dot_product_attention
    for name, (kw, causal, window, timed) in {
            "main (8 x 512, hq 24 / hkv 8, d 128, bf16, causal)":
                ({}, True, None, True),
            "long (1 x 8192, bf16, causal)": (dict(b=1, sq=8192, sk=8192),
                                              True, None, True),
            "gemma3 widths (hq 16 / hkv 8, d 256, window 1024, 4096)":
                (dict(b=1, hq=16, sq=4096, sk=4096, d=256), True, 1024,
                 False),
            "chunk-aligned sq 128 / sk 1024": (dict(b=2, sq=128, sk=1024),
                                               True, None, False),
            "sq = sk = 500 (tails)": (dict(b=2, sq=500, sk=500), True, None,
                                      False),
            "not causal, sq 200 / sk 300": (dict(b=2, sq=200, sk=300), False,
                                            None, False),
            "sq 300 > sk 200 (leading rows see no key)":
                (dict(b=2, sq=300, sk=200), True, None, False),
            "f32 (2 x 512)": (dict(b=2, dtype=torch.float32), True, None,
                              False),
            "f32, d 64, window 100, sq 200 / sk 700":
                (dict(b=1, hq=8, hkv=2, sq=200, sk=700, d=64,
                      dtype=torch.float32), True, 100, False),
            # every bf16 head dim and tile shape of the tensor-core kernel:
            # d 32 and 64 (128-row q tiles), 192 (64-row q tiles, 32-key
            # tiles), a single row and a ragged 17-row tile against 64
            # keys, and a long range with no mask at all.
            "bf16, d 32, hq 8 / hkv 2, 2 x 300":
                (dict(b=2, hq=8, hkv=2, sq=300, sk=300, d=32), True, None,
                 False),
            "bf16, d 64, window 100, sq 200 / sk 700":
                (dict(b=1, hq=8, hkv=2, sq=200, sk=700, d=64), True, 100,
                 False),
            "bf16, d 192, hq 4 / hkv 4, sq 250 / sk 1000":
                (dict(b=2, hq=4, hkv=4, sq=250, sk=1000, d=192), True, None,
                 False),
            "bf16, sq 1 / sk 64": (dict(b=2, sq=1, sk=64), True, None,
                                   False),
            "bf16, sq 17 / sk 64": (dict(b=2, sq=17, sk=64), True, None,
                                    False),
            "bf16, not causal, 1 x 8192": (dict(b=1, sq=8192, sk=8192),
                                           False, None, False)}.items():
        q, k, v = make_attention(gen, **kw)
        bound = library = None
        if timed:
            bound = attention_bound(q, k, causal, window, card)
            library = (lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                       "F.scaled_dot_product_attention, is_causal, "
                       "enable_gqa")
        res["flash_attention"][name] = run_case(
            "B5", name,
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window),
            "bf16" if q.dtype == torch.bfloat16 else TOL_F32, flush, bound,
            library)
        del q, k, v, library
        torch.cuda.empty_cache()
    return res


# --- phase 2, continued: the SSD chunked scan (B6) --------------------------------------


def ssd_inputs(gen, b, s, h, dh, ds, a_scale=1.0):
    """x, dt, A, B, C at the JAX tests' scales: x, B, C ~ 0.5 N(0, 1),
    dt ~ U(0.1, 0.5), A = -U(0.5, 1.5) (times ``a_scale``); fp32 on the
    card."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE) * 0.5

    return (randn(b, s, h, dh), 0.1 + 0.4 * rand(b, s, h),
            -(0.5 + rand(h)) * a_scale, randn(b, s, ds), randn(b, s, ds))


def ssd_bound(x, B, chunk, card):
    """Least time of one scan: x, y, B, C, dt and A moved once; at the
    fp32 peak, the Q x Q products over the causal triangle and the two
    state products.  B and C are shared by the heads (ngroups = 1), so
    C·Bᵀ, Q(Q+1) ds flops per chunk, is needed once per (b, chunk); the
    (C·Bᵀ)-weighted sum of x, Q(Q+1) dh, and the state products,
    4 Q ds dh, once per (b, h, chunk)."""
    b, s, h, dh = x.shape
    ds = B.shape[-1]
    nbytes = 4 * (2 * x.numel() + 2 * B.numel() + b * s * h + h)
    per_chunk = (chunk * (chunk + 1) * ds
                 + h * (chunk * (chunk + 1) * dh + 4 * chunk * ds * dh))
    ops = float(per_chunk) * (s // chunk) * b
    return {**bound_of(nbytes, ops, PEAK_F32, card), "flops": ops}


def phase_ssd_kernel(gen, card, flush):
    """B6 against its plain twin on the card, timed at every shape beside
    its bound (no single PyTorch call computes the scan); a length that
    is not a multiple of the chunk raises."""
    from repro_torch.kernels.ssd_scan import (ssd_plan, ssd_scan,
                                              ssd_scan_plain)
    res = {}
    for name, (b, s, h, dh, ds, chunk, *a_scale) in {
            "main (one mamba2 layer: b 4 x s 2048, h 64, dh 64, ds 128, "
            "chunk 256)": (4, 2048, 64, 64, 128, 256),
            "long (b 1 x s 16384, mamba2 widths)":
                (1, 16384, 64, 64, 128, 256),
            "zamba2 widths (b 4 x s 2048, ds 64)":
                (4, 2048, 64, 64, 64, 256),
            "small odd (b 2, h 3, s 192, dh 32, ds 48, chunk 64)":
                (2, 192, 3, 32, 48, 64),
            "chunk 48, dh 16, ds 16 (b 3, h 5, s 240)":
                (3, 240, 5, 16, 16, 48),
            "one chunk of 1024 (b 2, h 4, s 1024, dh 64, ds 128)":
                (2, 1024, 4, 64, 128, 1024),
            "deep decay, |A| x 200 (b 2, h 8, s 2048, dh 64, ds 128)":
                (2, 2048, 8, 64, 128, 256, 200.0)}.items():
        x, dt, A, B, C = ssd_inputs(gen, b, s, h, dh, ds, *a_scale)
        plan = ssd_plan(b, s, h, dh, ds, chunk)
        row = run_case("B6", name, lambda: ssd_scan(x, dt, A, B, C, chunk),
                       lambda: ssd_scan_plain(x, dt, A, B, C, chunk),
                       TOL_SSD, flush, ssd_bound(x, B, chunk, card),
                       info={"ctas": plan["ctas"],
                             "scratch_bytes": plan["scratch_bytes"]})
        ref = ssd_scan_plain(x, dt, A, B, C, chunk)
        row["max_abs_y"] = ref.abs().max().item()
        row["err_rel_to_max_y"] = row["max_abs_err"] / row["max_abs_y"]
        row["library"] = "no single PyTorch call"
        check(torch.isfinite(ssd_scan(x, dt, A, B, C, chunk)).all().item(),
              f"B6 [{name}]: non-finite output")
        print(f"B6 [{name}]: worst error {row['max_abs_err']:.3g} = "
              f"{row['err_rel_to_max_y']:.3g} of max |y| "
              f"{row['max_abs_y']:.4g}")
        res[name] = row
        del x, dt, A, B, C, ref
    x, dt, A, B, C = ssd_inputs(gen, 1, 200, 2, 32, 16)
    before = ssd_scan.launches
    try:
        ssd_scan(x, dt, A, B, C, 64)
    except ValueError as e:
        print(f"B6 [s 200, chunk 64]: raises ValueError ({e})")
    else:
        raise AssertionError("B6 accepted s % chunk != 0")
    check(ssd_scan.launches == before, "B6 launched on a ragged length")
    torch.cuda.empty_cache()
    return res


# --- phase 3: exactness at smoke width ------------------------------------------------


def kernel_counts():
    """{name: wrapper} for every kernel of the port; each wrapper counts
    its own launches in ``.launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kv_quant as kq
    from repro_torch.kernels import rmsnorm_kernel as rk
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels import treereduce_kernel as tk
    return {"flash_attention_decode_paged": fa.flash_attention_decode_paged,
            "flash_attention_decode": fa.flash_attention_decode,
            "kv_quantize": kq.kv_quantize,
            "kv_quantize_store": kq.kv_quantize_store,
            "kv_dequantize": kq.kv_dequantize,
            "stencil2d": st.stencil2d,
            "tree_row_reduce": tk.tree_row_reduce,
            "rmsnorm": rk.rmsnorm,
            "flash_attention": fa.flash_attention,
            "ssd_scan": ss.ssd_scan}


def reset_counts(counts):
    for fn in counts.values():
        fn.launches = 0


def read_counts(counts):
    return {name: fn.launches for name, fn in counts.items()}


def count_prefills(bat):
    """Count a dense-slot batcher's prefill calls (one per admitted
    bucket) in ``bat.prefill_calls``."""
    bat.prefill_calls = 0
    if bat.paged:
        return
    inner = bat._admit_fn

    def counted(*args):
        bat.prefill_calls += 1
        return inner(*args)

    bat._admit_fn = counted


def b2_launches_expected(cfg, bat):
    """B2's launches on an int8 serve, exactly: one store per layer for
    every decode step (and every paged prefill chunk); two quantize
    launches per layer for every dense prefill (its whole-cache
    conversion); two dequantize launches per layer for every dense
    decode step (the slot cache read back) and every paged chunk (the
    pool gathered), none for a paged decode step through B1."""
    L = cfg.n_layers
    if bat.paged:
        return {"kv_quantize_store": (bat.steps + bat.prefill_chunks) * L,
                "kv_quantize": 0,
                "kv_dequantize": 2 * bat.prefill_chunks * L}
    return {"kv_quantize_store": bat.steps * L,
            "kv_quantize": 2 * bat.prefill_calls * L,
            "kv_dequantize": 2 * bat.steps * L}


def run_batcher(cfg, params, prompts, max_news, **kw):
    import threading
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    bat = ContinuousBatcher(cfg, params, device=DEVICE, **kw)
    count_prefills(bat)
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

    # dense slots through B3 (and B2 for int8) vs the dense greedy oracle,
    # whose decode reads through the plain attention path.
    counts = kernel_counts()
    dense_int8 = None
    for label, kw in (("bf16", {}), ("sliding_window=16 ring",
                                     {"sliding_window": 16}),
                      ("int8", {"kv_cache_dtype": "int8"})):
        c = dataclasses.replace(base, **kw)
        gold = [list(greedy_generate(c, params, {"tokens": p[None]},
                                     steps=m, max_seq=48, device=DEVICE)[0])
                for p, m in zip(prompts, max_news)]
        reset_counts(counts)
        got, bat = run_batcher(dataclasses.replace(c, decode_flash=True),
                               params, prompts, max_news, n_slots=3,
                               max_seq=48)
        n = read_counts(counts)
        check(not bat.paged, "dense-slot batcher ran paged")
        check(got == gold, f"dense-slot+B3 [{label}] {got} != greedy {gold}")
        check(n["flash_attention_decode"] == bat.steps * c.n_layers,
              f"dense-slot [{label}] did not decode through B3: {n}")
        if kw.get("kv_cache_dtype") == "int8":
            want = b2_launches_expected(c, bat)
            check({k: n[k] for k in want} == want, f"int8 dense-slot B2 "
                  f"launches {n} != {want}")
            dense_int8 = got
        else:
            check(n["kv_quantize_store"] == n["kv_quantize"] == 0,
                  f"bf16 dense-slot ran B2's quantize: {n}")
        print(f"smoke exactness: dense-slot [{label}] through the kernels "
              f"token-identical to dense greedy ({bat.steps} steps, "
              f"launches {json.dumps(n)})")

    # a cache of several 64-key tiles, so that B3 splits each (slot, kv
    # head) over CTAs: prompts that reach past the first tiles.
    from repro_torch.kernels.flash_attention import dense_splits
    long_plens, long_news, long_seq = [100, 170, 230], [12, 10, 8], 512
    long_prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
                    for n in long_plens]
    gold = [list(greedy_generate(base, params, {"tokens": p[None]},
                                 steps=m, max_seq=long_seq, device=DEVICE)[0])
            for p, m in zip(long_prompts, long_news)]
    reset_counts(counts)
    got, bat = run_batcher(dataclasses.replace(base, decode_flash=True),
                           params, long_prompts, long_news, n_slots=3,
                           max_seq=long_seq)
    n = read_counts(counts)
    n_split = dense_splits(3, base.n_kv_heads, long_seq,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    check(n_split > 1, f"max_seq {long_seq} did not split B3: {n_split}")
    check(got == gold, f"dense-slot+B3 [max_seq {long_seq}] {got} != "
          f"greedy {gold}")
    check(n["flash_attention_decode"] == bat.steps * base.n_layers,
          f"dense-slot [max_seq {long_seq}] did not decode through B3: {n}")
    print(f"smoke exactness: dense-slot [bf16, max_seq {long_seq}, prompts "
          f"{long_plens}] through B3 at n_split {n_split} token-identical "
          f"to dense greedy ({bat.steps} steps)")

    # int8 pages (B1's int8 branch + B2) vs the int8 dense slots.
    c = dataclasses.replace(base, kv_cache_dtype="int8", decode_flash=True,
                            kv_page_size=8)
    reset_counts(counts)
    got, bat = run_batcher(c, params, prompts, max_news, n_slots=3,
                           max_seq=48, prefill_chunk=32, n_pages=5)
    n = read_counts(counts)
    check(bat.paged and bat.preemptions > 0,
          "int8 paged run did not preempt")
    check(got == dense_int8, f"int8 paged {got} != int8 dense {dense_int8}")
    check(bat.total_used_pages() == 0, "pages leaked")
    want = b2_launches_expected(c, bat)
    check(n["flash_attention_decode_paged"] == bat.steps * c.n_layers
          and {k: n[k] for k in want} == want,
          f"int8 paged launches {n} != steps {bat.steps} x layers and "
          f"{want}")
    print(f"smoke exactness: int8 paged with a 5-page pool "
          f"({bat.preemptions} preemptions) token-identical to int8 dense "
          f"slots (launches {json.dumps(n)})")


def motif_prompts(plens, vocab, rng):
    """Prompts that cycle a 4-token motif of their own, so the n-gram
    drafter finds matches in the history."""
    return [np.tile(rng.integers(0, vocab, 4), n // 4 + 1)[:n].astype(
        np.int32) for n in plens]


def serve_seq(bat, prompts, max_new):
    """Serve requests one after another through one batcher, so its
    prefix index holds each retired prompt when the next arrives."""
    from repro_torch.serve.batching import Request, drain
    outs = []
    for i, p in enumerate(prompts):
        r = Request(rid=i, prompt=p, max_new=max_new)
        bat.submit(r)
        bat.run(bat.retired + 1)
        outs.append(drain(r))
    return outs


def empty_index(bat):
    """Check every allocator, evict every cached prefix and check that no
    page is left in use."""
    for alloc in bat._alloc.values():
        alloc.check_consistency()
    held = bat._prefix.n_pages if bat._prefix is not None else 0
    check(bat.total_used_pages() == held * len(bat._alloc),
          f"{bat.total_used_pages()} pages in use, the index holds {held}")
    while bat._prefix is not None and bat._prefix.n_nodes:
        for name, pgs in bat._prefix.evict_lru()[1].items():
            bat._alloc[name].free(pgs)
    check(bat.total_used_pages() == 0, "pages leaked")


def phase_prefix_spec_exactness(seed):
    """The prefix cache and speculative decode at smoke width (fp32
    compute, bf16 or int8 pools, B1 for every decode and verify step):
    a prefix hit gives the cold run's tokens, ``prefill_exact`` installs
    the same pool bits however the prompt was chunked, speculation gives
    plain greedy decode's tokens (bf16 and int8 pools) with B1 launched
    once per layer for every decode and verify step, and every allocator
    ends consistent with no page in use.  The weights are drawn on the
    host from the seed and moved to the card, as the CPU rehearsal draws
    them."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    base = smoke_variant(get("minitron-4b"))
    params = PP.tree_map(lambda _, a: a.to(DEVICE),
                         registry.init(base, seed, device="cpu"))
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 19)
    cfg = dataclasses.replace(base, kv_page_size=8, decode_flash=True,
                              prefix_cache=True)

    P = rng.integers(0, base.vocab_size, 32).astype(np.int32)
    bat = ContinuousBatcher(cfg, params, n_slots=2, max_seq=64,
                            prefill_chunk=8, device=DEVICE)
    cold, hit = serve_seq(bat, [P, P], 6)
    check(hit == cold, f"prefix hit {hit} != cold {cold}")
    check(bat.prefix_hits == 1 and bat.prefill_chunks == 4 + 1,
          f"hits {bat.prefix_hits}, chunks {bat.prefill_chunks}")
    empty_index(bat)

    # prefill_exact: the installed prompt pages are the same bits from
    # one 64-token chunk and from chunks of 16 with the exact final pass.
    P = rng.integers(0, base.vocab_size, 40).astype(np.int32)
    snaps, toks = [], []
    for chunk, exact in ((64, False), (16, True)):
        bat = ContinuousBatcher(
            dataclasses.replace(cfg, prefix_cache=False,
                                prefill_exact=exact),
            params, n_slots=1, max_seq=64, prefill_chunk=chunk,
            device=DEVICE)
        r = Request(rid=0, prompt=P, max_new=4)
        bat.submit(r)
        bat.admit()
        while bat._admitting:
            bat._prefill_step()
        pages = bat._slot_pages["kv"][0][:5]
        snaps.append({k: bat.pools["kv"][k][:, pages].clone()
                      for k in ("k", "v")})
        bat.run(1)
        toks.append(drain(r))
        empty_index(bat)
    check(all(torch.equal(snaps[0][k], snaps[1][k]) for k in ("k", "v")),
          "prefill_exact pools differ between chunkings")
    check(toks[0] == toks[1], f"prefill_exact tokens {toks}")

    # speculation vs plain greedy, bf16 and int8 pools, with a prefix
    # re-hit: the last two requests repeat the first two.
    prompts = motif_prompts([9, 14, 6, 12], base.vocab_size, rng)
    prompts += prompts[:2]
    for kv in ("bfloat16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv, prefill_chunk=8,
                                prefill_exact=True, speculate_ngram=1)
        outs = {}
        for k in (0, 4):
            reset_counts(counts)
            got, bat = run_batcher(dataclasses.replace(c, speculate_k=k),
                                   params, prompts, [16] * len(prompts),
                                   n_slots=2, max_seq=48)
            n = read_counts(counts)["flash_attention_decode_paged"]
            check(n == bat.steps * c.n_layers, f"[{kv}, k {k}] B1 launches "
                  f"{n} != steps {bat.steps} x layers")
            outs[k] = got
            empty_index(bat)
        sp = bat.stats()["speculation"]
        check(outs[4] == outs[0], f"[{kv}] speculative {outs[4]} != plain "
              f"{outs[0]}")
        check(sp["verify_steps"] > 0 and sp["drafted"] > 0,
              f"[{kv}] nothing drafted: {sp}")
        print(f"smoke exactness [prefix cache + speculate_k 4, {kv} pools]: "
              f"6 requests token-identical to plain decode; "
              f"{bat.prefix_hits} prefix hits, {bat.steps} steps "
              f"({sp['verify_steps']} verify), drafted {sp['drafted']}, "
              f"accepted {sp['accepted']}, B1 launches {n} = steps x "
              f"{c.n_layers}")
    print("smoke exactness: prefix hit == cold (1 catch-up chunk); "
          "prefill_exact pools bit-equal across chunkings; every allocator "
          "consistent, no page in use")
    del params
    torch.cuda.empty_cache()


RECURRENT = ("mamba2-1p3b", "zamba2-1p2b")


def n_shared(cfg) -> int:
    """Decode-attention layers per step: zamba2's shared-block sites."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every \
        else 0


def phase_recurrent_exactness(seed):
    """The recurrent families at smoke width (fp32): the dense-slot
    batcher, asked for pages, serves dense slots and streams the greedy
    oracle's tokens (zamba2's shared block decoding through B3); the
    train forward through B6 matches the plain chunked formula."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import registry
    from repro_torch.serve.serve_loop import greedy_generate
    counts = kernel_counts()
    rng = np.random.default_rng(seed)
    plens, max_news = [5, 11, 19], [14, 12, 10]
    for arch in RECURRENT:
        base = smoke_variant(get(arch))
        params = registry.init(base, seed, device=DEVICE)
        prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
                   for n in plens]
        gold = [list(greedy_generate(base, params, {"tokens": p[None]},
                                     steps=m, max_seq=48, device=DEVICE)[0])
                for p, m in zip(prompts, max_news)]
        cfg = dataclasses.replace(base, kv_page_size=8, decode_flash=True)
        reset_counts(counts)
        got, bat = run_batcher(cfg, params, prompts, max_news, n_slots=2,
                               max_seq=48)
        n = read_counts(counts)
        check(not bat.paged, f"{arch}: kv_page_size served paged")
        check(got == gold, f"{arch} dense-slot batcher {got} != greedy "
              f"{gold}")
        check(n["flash_attention_decode"] == bat.steps * n_shared(cfg),
              f"{arch}: B3 launches {n} != steps {bat.steps} x shared "
              f"sites {n_shared(cfg)}")

        tok = torch.from_numpy(rng.integers(0, base.vocab_size, (2, 64))).to(
            DEVICE)
        reset_counts(counts)
        fast = registry.forward(dataclasses.replace(base, use_pallas=True),
                                params, {"tokens": tok})
        b6 = counts["ssd_scan"].launches
        plain = registry.forward(base, params, {"tokens": tok})
        err = (fast - plain).abs().max().item()
        check(b6 == base.n_layers, f"{arch}: B6 launches {b6} != layers "
              f"{base.n_layers}")
        check(torch.isfinite(fast).all().item() and err <= TOL_SMOKE_LOGITS,
              f"{arch}: train logits through B6 vs plain: {err}")
        print(f"smoke exactness [{arch}]: 3 requests through the dense-slot "
              f"batcher (page size ignored) token-identical to greedy "
              f"({bat.steps} steps, B3 launches "
              f"{n['flash_attention_decode']}); train logits through B6 "
              f"({b6} launches) vs plain: max abs err {err:.3g} (tol "
              f"{TOL_SMOKE_LOGITS})")
        del params, fast, plain
    torch.cuda.empty_cache()


# --- phase 4: full-width serve --------------------------------------------------------


# device kernel names (demangled, as the profiler reports them) by class.
SPLIT = (("B1_flash_decode_paged", ("flash_decode_paged_kernel",
                                    "flash_decode_paged_combine")),
         ("B3_flash_decode", ("flash_decode_kernel",
                              "flash_decode_combine")),
         ("B2_kv_quantize", ("kv_quantize_store_kernel",)),
         ("B2_kv_dequantize", ("kv_dequantize_kernel",)),
         ("B6_ssd_scan", ("ssd_cb_kernel", "ssd_state_kernel",
                          "ssd_pass_kernel", "ssd_out_kernel")),
         ("matmul", ("gemm", "nvjet", "cublas", "cutlass", "splitKreduce")))


def profile_window(fn, n: int):
    """Wall time per call of ``fn`` (which must end in a synchronizing
    copy) over ``n`` unprofiled calls, then device busy time per call from
    a ``torch.profiler`` trace of ``n`` more: the sum of the card's kernel
    and copy intervals (one stream, so they do not overlap), split into
    the port's kernels, matrix products and everything else, with the
    kernels launched per call (copies and fills counted apart), also by
    class."""
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
    split = {key: 0.0 for key, _ in SPLIT}
    split["other"] = 0.0
    kernels = dict.fromkeys(split, 0)
    copies = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = next((k for k, pats in SPLIT
                    if any(pat in ev.name for pat in pats)), "other")
        split[key] += ev.time_range.elapsed_us()
        if ev.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels[key] += 1
    busy = sum(split.values()) / n / 1e3
    out = {"wall_ms": wall * 1e3,
           "device_busy_ms": busy if busy else "not measured"}
    if busy:
        out["device_idle_share"] = 1.0 - busy / (wall * 1e3)
        out.update({f"{k}_ms": v / n / 1e3 for k, v in split.items()})
        out["kernels_per_call"] = sum(kernels.values()) / n
        out["copies_per_call"] = copies / n
        out["kernels_per_call_by_class"] = {k: c / n for k, c in
                                            kernels.items()}
    return out


def stamped_stream():
    """A response stream that notes when its first token arrives."""
    from repro_torch.core.stream import Stream

    class Stamped(Stream):
        def __init__(self):
            super().__init__(depth=4096, name="resp")
            self.first_at = None

        def Push(self, value, timeout=None):
            if self.first_at is None:
                self.first_at = time.perf_counter()
            super().Push(value, timeout)

    return Stamped()


# the full-width traffic: 8 slots, 16 requests, prompts 256-512,
# 64 new tokens, max_seq 1024; paged runs use page 16 and chunk 128.
N_SLOTS, N_REQ, MAX_NEW, MAX_SEQ, PAGE, CHUNK = 8, 16, 64, 1024, 16, 128


def serve_full_width(cfg, params, seed, counts, prompts=None,
                     max_seq=MAX_SEQ, n_pages=None):
    """The traffic above (or ``prompts``, MAX_NEW tokens each) through
    ``ContinuousBatcher`` under ``DataflowContext``; kernel counts are set
    to 0 just before and read just after.  Paged runs also report each
    page group's pages in use at its peak (sampled wherever the batcher
    notes its peak: admission, decode growth, speculation's scratch).
    ``n_pages`` sizes the page pools (the batcher's default: each group's
    table width times the slots).  Returns (summary, launches, batcher,
    outputs)."""
    from repro_torch.core.dataflow import DataflowContext
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
            256, 513))).astype(np.int32) for _ in range(N_REQ)]
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW, out=stamped_stream())
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    bat = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_seq=max_seq,
                            n_pages=n_pages, device=DEVICE)
    count_prefills(bat)
    step_s = []
    shared = [0]
    inner_step = bat.step
    group_peak = {}
    if bat.paged:
        inner_note = bat._note_peak

        def note_peak():
            inner_note()
            for name, a in bat._alloc.items():
                group_peak[name] = max(group_peak.get(name, 0), a.used_pages)

        bat._note_peak = note_peak

    def timed_step():
        t0 = time.perf_counter()
        n = inner_step()            # ends in the step's device->host copy
        step_s.append(time.perf_counter() - t0)
        if bat.paged:
            shared[0] = max(shared[0], sum(a.shared_pages
                                           for a in bat._alloc.values()))
        return n

    bat.step = timed_step
    submitted = {}

    def producer():
        for r in reqs:
            submitted[r.rid] = time.perf_counter()
            bat.submit(r)

    reset_counts(counts)
    t0 = time.perf_counter()
    with DataflowContext() as df:
        df.function(producer, name="producer")
        df.function(bat.run, len(reqs), name="batcher")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)

    outs = [drain(r) for r in reqs]
    check(all(len(o) == MAX_NEW for o in outs),
          f"token counts {[len(o) for o in outs]} != {MAX_NEW}")
    check(all(0 <= t < cfg.padded_vocab for o in outs for t in o),
          "token id out of range")
    if bat.paged:
        empty_index(bat)
    check(bat.total_used_pages() == 0, "pages leaked")
    tokens = sum(len(o) for o in outs)
    ttft = [r.out.first_at - submitted[r.rid] for r in reqs]
    summary = {
        "mode": "paged" if bat.paged else "dense",
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "requests": N_REQ, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": bat.steps,
        "prefill_chunks": bat.prefill_chunks,
        "prefill_calls": bat.prefill_calls,
        "median_step_ms": statistics.median(step_s) * 1e3,
        "ttft_median_s": statistics.median(ttft), "ttft_max_s": max(ttft),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }
    if bat.paged:
        summary["peak_pages"] = bat.peak_pages
        summary["peak_pages_by_group"] = group_peak
        summary["n_blocks"] = dict(bat.n_blocks)
    if bat.paged and bat.prefix_cache:
        st = bat.stats()
        summary["prefix"] = {k: st.get(k) for k in (
            "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
            "prefix_evictions", "cow_copies")}
        summary["prefix"]["peak_shared_pages"] = shared[0]
    if bat.paged and bat.speculate_k:
        summary["speculation"] = {k: bat.stats()["speculation"][k] for k in (
            "drafted", "accepted", "rolled_back", "verify_steps")}
    return summary, launches, bat, outs


def compare_logits(cfg, params, cache, tokens, pos, label, hold=True,
                   inputs=None):
    """One decode step's logits through the kernels vs the plain path
    (``decode_flash`` off), each step on its own copy of the cache (a
    step writes its K/V row and advances recurrent state in place).
    ``hold=False`` reports without holding: behind an MoE block a
    one-ulp change of the attention output can flip a token's top-k
    experts, which moves its logits by far more than the kernel's
    error (the kernel itself is held at the served shapes in phase 2).
    ``inputs``: the step's other inputs (musicgen's ``cond``)."""
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    logits = {}
    for flash in (True, False):
        c = dataclasses.replace(cfg, decode_flash=flash)
        logits[flash], _ = registry.forward(
            c, params, {"tokens": tokens[:, None].long(), **(inputs or {})},
            mode="decode",
            cache=PP.tree_map(lambda _, a: a.clone(), cache), pos=pos)
    a, b = logits[True].float(), logits[False].float()
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"full-width decode logits [{label}], kernels vs plain: max_abs_err "
          f"{err:.4g} (max |logit| {scale:.4g}, rel tol {TOL_LOGITS_REL}), "
          f"argmax agreement {agree:.3f}")
    check(torch.isfinite(a).all().item(), f"non-finite logits [{label}]")
    check(err <= TOL_LOGITS_REL * scale or not hold,
          f"full-width logits disagree [{label}]")


def prefill_pools(cfg, params, rng, max_seq=MAX_SEQ, plens=(100, 900)):
    """Page pools of a full-width paged config (8 slots, each a full
    table row of its own in every page group: 64 pages of minitron's flat
    group at max_seq 1024), every slot prefilled through the chunk step
    with a prompt of ``plens`` tokens (drawn in [lo, hi)).  Returns
    (pools, block tables by group, slot state [last_tok, pos, remaining,
    active], chunk step, chunks run)."""
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.models.cache_layouts import get_layout
    from repro_torch.serve.serve_loop import make_chunk_prefill_step
    n_slots, page, chunk = N_SLOTS, PAGE, CHUNK
    layout = get_layout(cfg, page)
    nbs = {g.name: layout.n_blocks(g.name, max_seq) for g in layout.groups}
    pools = PP.init_params(registry.paged_cache_decls(
        cfg, {n: n_slots * nb for n, nb in nbs.items()}, page),
        device=DEVICE)
    bt = {n: torch.arange(n_slots * nb, device=DEVICE,
                          dtype=torch.int32).reshape(n_slots, nb)
          for n, nb in nbs.items()}
    zero = torch.zeros(n_slots, dtype=torch.int32, device=DEVICE)
    state = [zero.clone(), zero.clone(), zero.clone(), zero.bool()]
    fn = make_chunk_prefill_step(cfg, chunk, max_seq, page)
    plens = rng.integers(*plens, n_slots)
    n_chunks = 0
    for s, plen in enumerate(plens):
        prompt = rng.integers(0, cfg.vocab_size, int(plen))
        for base_pos in range(0, int(plen), chunk):
            seg = np.zeros((1, chunk), np.int64)
            part = prompt[base_pos:base_pos + chunk]
            seg[0, :len(part)] = part
            final = base_pos + chunk >= plen
            last = (plen - 1 - base_pos) if final else chunk - 1
            pools, *state, _ = fn(
                params, pools, bt, *state,
                torch.from_numpy(seg).to(DEVICE),
                torch.full((1,), base_pos, dtype=torch.int32, device=DEVICE),
                torch.full((1,), int(last), dtype=torch.int32, device=DEVICE),
                s, final, int(plen), 4, 0)
            n_chunks += 1
    return pools, bt, state, fn, n_chunks


def same_through_twin(label, step, cache):
    """Run ``step(cache)`` (one decode step, writing the cache in place)
    once through B2's store kernel and once with the model calling its
    plain twin instead, each on its own copy of ``cache``: every leaf
    after the step must be equal, bit for bit."""
    from repro_torch.kernels.kv_quant import kv_quantize_store_plain
    from repro_torch.models import layers
    from repro_torch.models import params as PP
    after = {}
    kernel = layers.kv_quantize_store
    for route in ("kernel", "twin"):
        c = PP.tree_map(lambda _, a: a.clone(), cache)
        layers.kv_quantize_store = kernel if route == "kernel" \
            else kv_quantize_store_plain
        try:
            step(c)
            torch.cuda.synchronize()
        finally:
            layers.kv_quantize_store = kernel
        after[route] = PP.tree_leaves(c)
    differ = sum(not torch.equal(a, b)
                 for a, b in zip(after["kernel"], after["twin"]))
    check(differ == 0, f"[{label}] {differ} cache leaves differ between "
          "B2's store kernel and its twin")
    print(f"full-width [{label}]: the caches after one step through B2's "
          f"store kernel and through its plain twin are equal "
          f"({len(after['kernel'])} leaves)")


def count_step(measured, label, fn, cfg, shape, prof):
    """One more call of ``fn`` (a full-width step on the card's real
    inputs, which its data-dependent row masks need) under the roofline
    counter; kept in ``measured[label]`` beside the step's profiled wall
    and busy ms for ``phase_roofline``.  ``shape``: (kind, seq, batch)."""
    from repro_torch.roofline import count as C
    with torch.no_grad(), C.Counter(scopes=False) as c:
        fn()
    torch.cuda.synchronize()
    measured[label] = {"cfg": cfg, "shape": shape, "ms": prof["wall_ms"],
                       "device_busy_ms": prof.get("device_busy_ms"),
                       "costs": c.costs}


def phase_full_width(seed, measured):
    """Full-width serves: paged through B1, then dense slots through B3
    with a bf16 and an int8 (B2) cache.  Returns {path: launches}; the
    paged decode step, a prefill chunk and the dense bf16 decode step go
    into ``measured`` with their counts (``count_step``)."""
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.serve_loop import (make_paged_decode_step as
                                              make_decode_step)

    base = dataclasses.replace(get("minitron-4b"), decode_flash=True)
    t = time.perf_counter()
    params = registry.init(base, seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in PP.tree_leaves(params))
    print(f"full width: minitron-4b, {n_params} bf16 parameters drawn on the "
          f"card in {time.perf_counter() - t:.2f}s")
    counts = kernel_counts()
    paths = {}

    # --- paged, bf16, through B1 ---
    n_slots, max_seq, page, chunk = N_SLOTS, MAX_SEQ, PAGE, CHUNK
    cfg = dataclasses.replace(base, kv_page_size=page, prefill_chunk=chunk)
    summary, launches, bat, _ = serve_full_width(cfg, params, seed, counts)
    check(launches["flash_attention_decode_paged"]
          == bat.steps * cfg.n_layers,
          f"B1 launches {launches} != steps {bat.steps} x layers "
          f"{cfg.n_layers}")
    print("full-width serve [paged bf16]: " + json.dumps(summary))
    paths["paged bf16"] = launches
    rng = np.random.default_rng(seed)

    # one decode step's logits, kernel vs plain, on prefilled pools.
    pools, bt, state, fn, _ = prefill_pools(cfg, params, rng)
    last_tok, pos = state[0], state[1]
    compare_logits(cfg, params, {"pages": pools, "block_tab": bt},
                   last_tok, pos, "paged bf16")

    # where a decode step's and a prefill chunk's time goes.
    step = make_decode_step(cfg, max_seq, page)
    active = torch.ones(n_slots, dtype=torch.bool, device=DEVICE)

    def decode_once():
        nonlocal pos
        _, _, pos, _, _, out = step(params, pools, bt, last_tok,
                                    pos, state[2] + 1000, active)
        out.cpu()

    seg = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, chunk))).to(
        DEVICE)

    def chunk_once():
        *_, tok = fn(params, pools, bt, *state, seg,
                     torch.zeros(1, dtype=torch.int32, device=DEVICE),
                     torch.full((1,), chunk - 1, dtype=torch.int32,
                                device=DEVICE), 0, False, chunk, 4, 0)
        tok.cpu()

    for f in (decode_once, chunk_once):
        f()
    prof = {"decode_step": profile_window(decode_once, 5),
            "prefill_chunk_128": profile_window(chunk_once, 3)}
    print("time split [paged bf16] (8 slots at ~100-900 positions): "
          + json.dumps(prof))
    count_step(measured, "minitron-4b paged decode step, 8 slots",
               decode_once, cfg, ("decode", max_seq, n_slots),
               prof["decode_step"])
    count_step(measured, "minitron-4b paged prefill chunk, 128 tokens",
               chunk_once, cfg, ("prefill", chunk, 1),
               prof["prefill_chunk_128"])
    del pools, step, fn, state
    torch.cuda.empty_cache()

    # --- dense slots through B3, bf16 and int8 (B2) caches ---
    for dt in ("bfloat16", "int8"):
        label = f"dense {dt}"
        cfg = dataclasses.replace(base, kv_cache_dtype=dt)
        summary, launches, bat, _ = serve_full_width(cfg, params, seed,
                                                     counts)
        check(not bat.paged, f"[{label}] ran paged")
        check(launches["flash_attention_decode"] == bat.steps * cfg.n_layers,
              f"[{label}] B3 launches {launches} != steps {bat.steps} x "
              f"layers {cfg.n_layers}")
        want = b2_launches_expected(cfg, bat) if dt == "int8" else dict(
            kv_quantize_store=0, kv_quantize=0, kv_dequantize=0)
        check({k: launches[k] for k in want} == want,
              f"[{label}] B2 launches {launches} != {want}")
        print(f"full-width serve [{label}]: " + json.dumps(summary))
        paths[label] = launches
        del bat
        torch.cuda.empty_cache()

        # 8 slots admitted at ~100-900 positions: logits and time split.
        bat = ContinuousBatcher(cfg, params, n_slots=n_slots,
                                max_seq=max_seq, device=DEVICE)
        for i, plen in enumerate(rng.integers(100, 900, n_slots)):
            bat.requests.Push(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, int(plen)).astype(np.int32), max_new=4))
        bat.admit()
        check(all(r is not None for r in bat._slot_req), "slots not filled")
        compare_logits(cfg, params, bat.cache, bat.last_tok, bat.pos, label)
        pos = bat.pos.clone()
        remaining = bat.remaining + 1000
        if dt == "int8":
            same_through_twin(f"{label} decode step", lambda c: bat._step(
                params, c, bat.last_tok, pos, remaining, active), bat.cache)

        def dense_once():
            nonlocal pos
            _, _, pos, _, _, out = bat._step(params, bat.cache, bat.last_tok,
                                             pos, remaining, active)
            out.cpu()

        dense_once()
        prof = profile_window(dense_once, 5)
        print(f"time split [{label}] (decode step, 8 slots at ~100-900 "
              "positions): " + json.dumps(prof))
        if dt == "bfloat16":
            count_step(measured, "minitron-4b dense decode step, 8 slots",
                       dense_once, cfg, ("decode", max_seq, n_slots), prof)
        del bat
        torch.cuda.empty_cache()

    # --- paged, int8 pools: B2's store on every chunk and decode step ---
    label = "paged int8"
    cfg = dataclasses.replace(base, kv_page_size=page, prefill_chunk=chunk,
                              kv_cache_dtype="int8")
    L = cfg.n_layers
    reset_counts(counts)
    pools, bt, state, fn, n_chunks = prefill_pools(
        cfg, params, np.random.default_rng(seed + 1))
    n = read_counts(counts)
    check(n["kv_quantize_store"] == n_chunks * L and n["kv_quantize"] == 0,
          f"[{label}] {n_chunks} prefill chunks launched {n}")
    last_tok, pos, rem = state[0], state[1], state[2] + 1000
    step = make_decode_step(cfg, max_seq, page)
    same_through_twin(f"{label} decode step", lambda c: step(
        params, c, bt, last_tok, pos, rem, active), pools)

    def decode_once():
        nonlocal pos
        _, _, pos, _, _, out = step(params, pools, bt, last_tok,
                                    pos, rem, active)
        out.cpu()

    def chunk_once():
        *_, tok = fn(params, pools, bt, *state, seg,
                     torch.zeros(1, dtype=torch.int32, device=DEVICE),
                     torch.full((1,), chunk - 1, dtype=torch.int32,
                                device=DEVICE), 0, False, chunk, 4, 0)
        tok.cpu()

    for f, want in ((decode_once, dict(kv_quantize_store=L, kv_quantize=0,
                                       kv_dequantize=0,
                                       flash_attention_decode_paged=L)),
                    (chunk_once, dict(kv_quantize_store=L, kv_quantize=0,
                                      kv_dequantize=2 * L))):
        reset_counts(counts)
        f()
        n = read_counts(counts)
        check({k: n[k] for k in want} == want,
              f"[{label}] {f.__name__} launched {n}, not {want}")
    prof = {"decode_step": profile_window(decode_once, 5),
            "prefill_chunk_128": profile_window(chunk_once, 3)}
    print(f"time split [{label}] (8 slots at ~100-900 positions): "
          + json.dumps(prof))
    del pools, step, fn, state
    torch.cuda.empty_cache()
    return paths


# the prefix-cache + speculation traffic: N_REQ requests sharing one
# SYS_LEN-token system prompt, each followed by 32-128 own tokens that
# cycle a 4-token motif, MAX_NEW new tokens; SPEC_K drafts per verify.
SYS_LEN, SPEC_K = 512, 4


def shared_prompt_traffic(vocab, rng):
    sysp = rng.integers(0, vocab, SYS_LEN)
    own = motif_prompts([int(n) for n in rng.integers(32, 129, N_REQ)],
                        vocab, rng)
    return [np.concatenate([sysp, o]).astype(np.int32) for o in own]


def drafts_possible(prompts, outs, k=SPEC_K):
    """Decode steps of plain greedy decode at which the single-token
    drafter would propose a full span: the last token occurred earlier
    in the history with k tokens after it."""
    n = 0
    for prompt, out in zip(prompts, outs):
        hist = [int(t) for t in prompt] + [out[0]]
        for t in out[1:]:
            n += hist[-1] in hist[:len(hist) - 1 - k]
            hist.append(t)
    return n


def hold_verify_span(cfg, params, pools, bt, pos, rng, counts):
    """One verify span (8 slots x SPEC_K + 1 tokens at ~100-900
    positions) against SPEC_K + 1 sequential decode steps of the same
    tokens, each from its own copy of the same pools: logits held to
    compare_logits's bf16 rule row by row, B1 launched once per layer.
    Returns the comparison's fields."""
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    k1 = SPEC_K + 1
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (N_SLOTS, k1))).to(DEVICE)
    copy = lambda: PP.tree_map(lambda _, a: a.clone(), pools)
    reset_counts(counts)
    span, span_pools = registry.forward(
        cfg, params, {"tokens": tokens}, mode="verify",
        cache={"pages": copy(), "block_tab": bt}, pos=pos)
    n_b1 = read_counts(counts)["flash_attention_decode_paged"]
    check(n_b1 == cfg.n_layers, f"verify span launched B1 {n_b1} times")
    seq_pools = copy()
    rows = []
    for i in range(k1):
        step, seq_pools = registry.forward(
            cfg, params, {"tokens": tokens[:, i:i + 1]}, mode="decode",
            cache={"pages": seq_pools, "block_tab": bt},
            pos=pos + i)
        a, b = span[:, i].float(), step[:, 0].float()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(torch.isfinite(a).all().item()
              and err <= TOL_LOGITS_REL * scale,
              f"verify row {i} vs decode step: {err} (max |logit| {scale})")
        rows.append({"max_abs_err": err, "max_abs_logit": scale,
                     "bit_equal": torch.equal(span[:, i], step[:, 0]),
                     "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float()
                     .mean().item()})
    diff = {leaf: (span_pools["kv"][leaf] != seq_pools["kv"][leaf]).float()
            .mean().item() for leaf in ("k", "v")}
    return {"rows": rows, "pool_share_differing": diff,
            "b1_launches": n_b1, "rel_tol": TOL_LOGITS_REL}


def phase_prefix_spec_full_width(seed):
    """Full-width minitron-4b, paged bf16 pools through B1
    (``decode_flash``), page 16, chunk 128, 8 slots, max_seq 1024: the
    shared-system-prompt traffic served plain, with the prefix cache and
    ``prefill_exact``, and with both and ``speculate_k`` 4 (the
    single-token drafter); B1's launches held to (decode steps + verify
    steps) x layers in each, drafts and prefix hits required, token
    identity between the runs reported as shares (bf16 at random weights:
    another GEMM shape may flip a rounding); one verify span held against
    sequential decode; one verify step's time split beside a decode
    step's.  Returns {path: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import registry
    from repro_torch.serve.serve_loop import (make_paged_decode_step,
                                              make_spec_verify_step)
    t_phase = time.perf_counter()
    plain = dataclasses.replace(get("minitron-4b"), decode_flash=True,
                                kv_page_size=PAGE, prefill_chunk=CHUNK)
    params = registry.init(plain, seed, device=DEVICE, dtype=torch.bfloat16)
    prefix = dataclasses.replace(plain, prefix_cache=True,
                                 prefill_exact=True)
    spec = dataclasses.replace(prefix, speculate_k=SPEC_K, speculate_ngram=1)
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 19)
    prompts = shared_prompt_traffic(plain.vocab_size, rng)
    paths, outs, summaries = {}, {}, {}
    for label, cfg in (("plain", plain), ("prefix cache", prefix),
                       ("prefix cache + speculate_k 4", spec)):
        summary, launches, bat, outs[label] = serve_full_width(
            cfg, params, seed, counts, prompts)
        n_verify = bat.spec_verify_steps       # bat.steps counts them too
        check(launches["flash_attention_decode_paged"]
              == bat.steps * cfg.n_layers,
              f"[{label}] B1 launches {launches} != (decode steps "
              f"{bat.steps - n_verify} + verify steps {n_verify}) x layers "
              f"{cfg.n_layers}")
        summaries[label] = summary
        paths[f"paged bf16 shared prompt, {label}"] = launches
        print(f"full-width serve [shared prompt, {label}]: "
              + json.dumps(summary))
        del bat
    st = summaries["prefix cache + speculate_k 4"]
    possible = drafts_possible(prompts, outs["plain"])
    check(st["speculation"]["verify_steps"] > 0
          and st["speculation"]["drafted"] > 0,
          f"no verify step ({st['speculation']}); plain decode offered "
          f"{possible} draftable steps")
    check(st["prefix"]["prefix_hits"] > 0, f"no prefix hit: {st['prefix']}")

    def identity(a, b):
        same = sum(x == y for x, y in zip(outs[a], outs[b]))
        share = np.mean([x == y for u, v in zip(outs[a], outs[b])
                         for x, y in zip(u, v)])
        return f"{same} of {N_REQ} requests, {share:.4f} of tokens"

    print(f"full-width shared prompt, token identity: prefix cache vs plain "
          f"{identity('prefix cache', 'plain')}; speculation vs prefix cache "
          f"{identity('prefix cache + speculate_k 4', 'prefix cache')}; "
          f"plain decode offered the drafter {possible} steps; tokens/s "
          + ", ".join(f"{k} {v['tokens_per_s']:.2f}"
                      for k, v in summaries.items())
          + " (reported, not claimed)")

    # one verify span against sequential decode, and the time split of a
    # verify step beside a decode step's, on pools prefilled at ~100-900.
    pools, bt, state, _, _ = prefill_pools(plain, params, rng)
    last_tok, pos = state[0], state[1]
    held = hold_verify_span(plain, params, pools, bt, pos, rng, counts)
    print("full-width verify span vs sequential decode: "
          + json.dumps(held))
    k1 = SPEC_K + 1
    verify = make_spec_verify_step(plain, k1, MAX_SEQ, PAGE)
    step = make_paged_decode_step(plain, MAX_SEQ, PAGE)
    n_pages = pools["kv"]["k"].shape[1]
    cap = N_SLOTS * ((k1 - 1) // PAGE + 2)
    nothing = ({"kv": np.zeros(cap, np.int32)},
               {"kv": np.full(cap, n_pages, np.int32)},
               {"kv": np.full(cap, N_SLOTS, np.int32)},
               {"kv": np.zeros(cap, np.int32)},
               {"kv": np.zeros(cap, np.int32)})
    tokens = torch.from_numpy(rng.integers(0, plain.vocab_size,
                                           (N_SLOTS, k1))).int().to(DEVICE)
    n_draft = torch.full((N_SLOTS,), SPEC_K, dtype=torch.int32,
                         device=DEVICE)
    rem = state[2] + 1000
    active = torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)

    def verify_once():
        *_, out = verify(params, pools, bt, tokens, n_draft, pos,
                         rem, active, *nothing)
        out.cpu()

    def decode_once():
        *_, out = step(params, pools, bt, last_tok, pos, rem,
                       active)
        out.cpu()

    for f in (verify_once, decode_once):
        f()
    prof = {"verify_step": profile_window(verify_once, 5),
            "decode_step": profile_window(decode_once, 5)}
    print(f"time split [paged bf16, verify span {k1} vs decode] (8 slots at "
          "~100-900 positions): " + json.dumps(prof))
    print(f"full-width prefix cache + speculation phase: "
          f"{time.perf_counter() - t_phase:.1f}s")
    del pools, params
    torch.cuda.empty_cache()
    return paths


# the recurrent families' train forward: b 4 x s 2048 (8 chunks of 256).
TRAIN_B, TRAIN_S = 4, 2048


def logit_diff(a, b):
    """Max abs difference of two logit tensors, beside max |b| and the
    share of positions whose argmax agrees."""
    a, b = a.float(), b.float()
    return {"max_abs_err": (a - b).abs().max().item(),
            "max_abs_logit": b.abs().max().item(),
            "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float()
            .mean().item()}


def phase_recurrent_full_width(seed):
    """mamba2-1p3b and zamba2-1p2b at full width, random bf16 weights
    from the seed: phase 4's traffic through the dense-slot batcher
    (exact-length admission; zamba2 with ``decode_flash``, B3 in its
    shared block), one decode step's logits through the kernels vs the
    plain path, a decode step's time split; then one train forward at
    b 4 x s 2048 through B6 (bf16, counted and timed, with its time
    split), its logits held to the plain scan's in fp32 compute.
    Returns {path: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request
    counts = kernel_counts()
    rng = np.random.default_rng(seed)
    paths = {}
    for arch in RECURRENT:
        base = get(arch)
        base = dataclasses.replace(base, decode_flash=n_shared(base) > 0)
        t = time.perf_counter()
        params = registry.init(base, seed, device=DEVICE,
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in PP.tree_leaves(params))
        print(f"full width: {arch}, {n_params} bf16 parameters drawn on "
              f"the card in {time.perf_counter() - t:.2f}s")

        summary, launches, bat, _ = serve_full_width(base, params, seed,
                                                     counts)
        check(not bat.paged, f"[{arch}] ran paged")
        check(launches["flash_attention_decode"]
              == bat.steps * n_shared(base),
              f"[{arch}] B3 launches {launches} != steps {bat.steps} x "
              f"shared sites {n_shared(base)}")
        print(f"full-width serve [{arch} dense]: " + json.dumps(summary))
        paths[f"{arch} serve"] = launches
        del bat
        torch.cuda.empty_cache()

        # 8 slots admitted at ~100-900 positions: logits and time split.
        bat = ContinuousBatcher(base, params, n_slots=N_SLOTS,
                                max_seq=MAX_SEQ, device=DEVICE)
        for i, plen in enumerate(rng.integers(100, 900, N_SLOTS)):
            bat.requests.Push(Request(rid=i, prompt=rng.integers(
                0, base.vocab_size, int(plen)).astype(np.int32), max_new=4))
        bat.admit()
        check(all(r is not None for r in bat._slot_req), "slots not filled")
        if n_shared(base):
            compare_logits(base, params, bat.cache, bat.last_tok, bat.pos,
                           arch)
        else:
            print(f"full-width decode logits [{arch}]: the decode step runs "
                  "no kernel of the port (B6 is on the train forward)")
        pos = bat.pos.clone()
        remaining = bat.remaining + 1000
        active = torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)

        def decode_once():
            nonlocal pos
            _, _, pos, _, _, out = bat._step(params, bat.cache, bat.last_tok,
                                             pos, remaining, active)
            out.cpu()

        decode_once()
        prof = profile_window(decode_once, 5)
        print(f"time split [{arch}] (decode step, 8 slots at ~100-900 "
              "positions): " + json.dumps(prof))
        del bat
        torch.cuda.empty_cache()

        # the train forward (bf16) through B6: the path, counted and timed.
        tok = torch.from_numpy(rng.integers(
            0, base.vocab_size, (TRAIN_B, TRAIN_S))).to(DEVICE)
        fast_cfg = dataclasses.replace(base, use_pallas=True)
        torch.cuda.synchronize()
        reset_counts(counts)
        t = time.perf_counter()
        fast = registry.forward(fast_cfg, params, {"tokens": tok})
        torch.cuda.synchronize()
        t_fast = time.perf_counter() - t
        launches = read_counts(counts)
        want = {name: 0 for name in counts}
        want["ssd_scan"] = base.n_layers
        check(launches == want, f"[{arch} train] launches {launches} != "
              f"{want}")
        check(tuple(fast.shape) == (TRAIN_B, TRAIN_S, base.padded_vocab)
              and torch.isfinite(fast).all().item(),
              f"[{arch} train] logits {tuple(fast.shape)} not finite")
        t = time.perf_counter()
        plain = registry.forward(base, params, {"tokens": tok})
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t

        def held_to_control(c, fast, plain):
            """B6 vs the plain scan, beside the control: the plain scan
            at half the chunk (the same function, its sums in another
            order) vs the plain scan, all in compute dtype ``c.dtype``."""
            check(torch.isfinite(fast).all().item(),
                  f"[{arch} train, {c.dtype}] non-finite logits through B6")
            half = registry.forward(dataclasses.replace(
                c, ssm_chunk=c.ssm_chunk // 2), params, {"tokens": tok})
            return {"b6_vs_plain": logit_diff(fast, plain),
                    "plain_half_chunk_vs_plain": logit_diff(half, plain)}

        bf16 = held_to_control(base, fast, plain)
        del fast, plain
        torch.cuda.empty_cache()
        b6, ctl = bf16["b6_vs_plain"], bf16["plain_half_chunk_vs_plain"]
        check(b6["max_abs_err"]
              <= TOL_TRAIN_BF16_ERR_VS_CONTROL * ctl["max_abs_err"]
              and 1 - b6["argmax_agreement"]
              <= TOL_TRAIN_BF16_DISAGREE_VS_CONTROL
              * (1 - ctl["argmax_agreement"]),
              f"[{arch} train, bf16 compute] logits through B6 stray from "
              f"the plain scan further than its control: {bf16}")
        # fp32 compute (the same bf16 weights), held to a fixed limit.
        c32 = dataclasses.replace(base, dtype="float32")
        f32 = held_to_control(
            c32, registry.forward(dataclasses.replace(c32, use_pallas=True),
                                  params, {"tokens": tok}),
            registry.forward(c32, params, {"tokens": tok}))
        b6 = f32["b6_vs_plain"]
        check(b6["max_abs_err"] <= TOL_TRAIN_F32_REL * b6["max_abs_logit"],
              f"[{arch} train, fp32 compute] logits through B6 disagree "
              f"with the plain scan: {f32}")
        torch.cuda.empty_cache()

        def train_once():
            registry.forward(fast_cfg, params, {"tokens": tok})
            torch.cuda.synchronize()

        prof = profile_window(train_once, 2)
        print(f"full-width train forward [{arch}, b {TRAIN_B} x s "
              f"{TRAIN_S}, use_pallas]: " + json.dumps({
                  "through_b6_s": t_fast, "plain_scan_s": t_plain,
                  "fp32_compute": f32, "fp32_rel_tol": TOL_TRAIN_F32_REL,
                  "bf16_compute": bf16, "launches": launches,
                  "time_split": prof}))
        paths[f"{arch} train"] = launches
        del params, tok
        torch.cuda.empty_cache()
    return paths


# --- the hlslib host runtime on the card (F2, F3's compiled mode) -----------------------


def phase_host_runtime():
    """The paper's Listing 2 through ``Context()`` (the card by default):
    buffers on the card, ``ExecuteTask`` returning finished results equal
    to the expected values, the read-only buffer refusing a host
    rewrite; ``fused_pipeline`` equal to composing its stages by hand on
    each microbatch; the quickstart twin on the card printing what it
    prints on the CPU (F7 to 1e-5)."""
    from repro_torch.core import Access, Context, MemoryBank
    from repro_torch.core.pipeline import fused_pipeline, pipeline_efficiency
    from repro_torch.examples import quickstart
    ctx = Context()
    check(ctx.device.type == "cuda", f"Context() chose {ctx.device}")
    N = 1 << 22
    program = ctx.MakeProgram({"Kernel": lambda a, b, n: (a * 2.0 + b, n)})
    in_dev = ctx.MakeBuffer(torch.float32, Access.read, MemoryBank.bank0,
                            np.full(N, 5.0, np.float32))
    out_dev = ctx.MakeBuffer(torch.float32, Access.write, MemoryBank.bank1,
                             N)
    check(in_dev.tensor.is_cuda and out_dev.tensor.is_cuda,
          "buffers not on the card")
    kernel = program.MakeKernel("Kernel", in_dev, out_dev, N)
    result, n = kernel.ExecuteTask()
    done = torch.cuda.current_stream().query()
    host = np.empty(N, np.float32)
    np.copyto(host, result.cpu().numpy())
    check(result.is_cuda and done and n == N and bool((host == 10.0).all()),
          f"Listing 2 on the card: finished {done}, values "
          f"{np.unique(host)[:4]}")
    try:
        in_dev.CopyFromHost(np.zeros(N, np.float32))
        check(False, "a read-only buffer took a host rewrite")
    except PermissionError:
        pass
    out_dev.CopyFromHost(np.arange(N, dtype=np.float32))
    check(bool((out_dev.CopyToHost() == np.arange(N)).all()),
          "write buffer round trip")
    fut = program.MakeKernel("Kernel", out_dev, in_dev, 3).ExecuteAsync()[0]
    check(torch.equal(fut, out_dev.tensor * 2.0 + in_dev.tensor),
          "ExecuteAsync result")

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    ws = [torch.randn((256, 256), generator=gen, device=DEVICE) * 0.06
          for _ in range(4)]
    stages = [lambda x, w=w: torch.tanh(x @ w) * 1.5 + 0.25 for w in ws]
    xs = torch.randn((6, 64, 256), generator=gen, device=DEVICE)
    ys = fused_pipeline(stages, xs)
    seq = []
    for x in xs:
        for f in stages:
            x = f(x)
        seq.append(x)
    check(ys.is_cuda, "fused_pipeline left the card")
    check(torch.equal(ys, torch.stack(seq)),
          "fused_pipeline != sequential composition")
    check(pipeline_efficiency(6, 4) == 6 / 9, "pipeline_efficiency")

    card_lines, cpu_lines = quickstart.run(), quickstart.run("cpu")
    check(card_lines[:4] == cpu_lines[:4],
          f"quickstart on the card {card_lines} != on the CPU {cpu_lines}")
    f7 = [[float(v) for v in line.split(":")[1].split("vs")[0].split()]
          + [float(line.rsplit(":", 1)[1])]
          for line in (card_lines[4], cpu_lines[4])]
    check(np.allclose(f7[0], f7[1], rtol=1e-5, atol=0), f"F7 {f7}")
    for line in card_lines:
        print(f"quickstart on the card: {line}")
    print(f"host runtime on the card: Listing 2 through Context() "
          f"({ctx.device}, {N} floats, ExecuteTask finished and equal), "
          "fused_pipeline == sequential composition (6 microbatches x 4 "
          "stages), quickstart's lines equal the CPU run's")


# --- gemma3-12b: the local/global layout ----------------------------------------------------


def phase_gemma3_exactness(seed):
    """gemma3 at smoke width (12 layers: 2 groups of 5 local layers with a
    16-token window and 1 global; fp32 compute, bf16 or int8 caches) on
    the card, prompts past the window: dense slots through B3 (the local
    layers on the rolled ring) give the dense greedy oracle's tokens;
    paged through B1 (the local layers on a ring of pages with
    ``page_base``) gives the dense slots' tokens, also with pools small
    enough to preempt; one request's pages stay within the ring's width
    plus the global table; speculative decode (``speculate_k`` 4, verify
    spans through B1 at sq = 5) gives plain decode's tokens; B1 and B3
    launched once per layer for every step.  The weights are drawn on
    the host from the seed and moved to the card, as the CPU rehearsal
    draws them."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.serve_loop import greedy_generate
    base = smoke_variant(get("gemma3-12b"))
    params = PP.tree_map(lambda _, a: a.to(DEVICE),
                         registry.init(base, seed, device="cpu"))
    L, w, page = base.n_layers, base.sliding_window, 8
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 3)
    plens, max_news, max_seq = [9, 21, 40], [20, 16, 12], 64
    prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
               for n in plens]
    for kv in ("bfloat16", "int8"):
        c = dataclasses.replace(base, kv_cache_dtype=kv)
        gold = [list(greedy_generate(c, params, {"tokens": p[None]}, steps=m,
                                     max_seq=max_seq, device=DEVICE)[0])
                for p, m in zip(prompts, max_news)]
        c = dataclasses.replace(c, decode_flash=True)
        reset_counts(counts)
        dense, bat = run_batcher(c, params, prompts, max_news, n_slots=3,
                                 max_seq=max_seq)
        n = read_counts(counts)
        check(not bat.paged and dense == gold,
              f"gemma3 dense [{kv}] {dense} != greedy {gold}")
        check(n["flash_attention_decode"] == bat.steps * L,
              f"gemma3 dense [{kv}] B3 launches {n} != steps {bat.steps} x "
              f"{L}")
        p = dataclasses.replace(c, kv_page_size=page)
        for pool in (None, {"local": 6, "global": 8}):
            reset_counts(counts)
            got, bat = run_batcher(p, params, prompts, max_news, n_slots=3,
                                   max_seq=max_seq, prefill_chunk=64,
                                   n_pages=pool)
            n = read_counts(counts)
            check(got == dense, f"gemma3 paged [{kv}, pool {pool}] {got} != "
                  f"dense {dense}")
            check(n["flash_attention_decode_paged"] == bat.steps * L,
                  f"gemma3 paged [{kv}] B1 launches {n} != steps "
                  f"{bat.steps} x {L}")
            check(pool is None or bat.preemptions > 0,
                  f"gemma3 paged [{kv}] pool {pool} did not preempt")
            empty_index(bat)
        print(f"gemma3 smoke exactness [{kv}]: prompts {plens} (window {w}) "
              f"dense slots through B3 == greedy; paged through B1 (ring "
              f"{bat.n_blocks['local']} pages, global "
              f"{bat.n_blocks['global']}) == dense, also with pools "
              f"{pool} ({bat.preemptions} preemptions)")

    # one request's pages: at most the ring's width plus the global table.
    p = dataclasses.replace(base, kv_page_size=page, decode_flash=True)
    gold = [list(greedy_generate(base, params, {"tokens": prompts[2][None]},
                                 steps=6, max_seq=max_seq,
                                 device=DEVICE)[0])]
    got, bat = run_batcher(p, params, prompts[2:], [6], n_slots=2,
                           max_seq=max_seq, prefill_chunk=64)
    bound = (w // page + 1) + -(-max_seq // page)
    peak = bat.peak_pages
    check(got == gold and peak <= bound,
          f"gemma3 window bound: {got} vs {gold}, peak {peak} > {bound}")

    # speculation vs plain, bf16 and int8 pools, decoding past the window
    # (prompts of their own 4-token motif, 30 new tokens; motifs on which
    # the smoke model accepts drafts, so that commits run too).
    prompts = motif_prompts([9, 14, 6, 12], base.vocab_size,
                            np.random.default_rng(seed + 20))
    for kv in ("bfloat16", "int8"):
        c = dataclasses.replace(p, kv_cache_dtype=kv, prefill_chunk=page,
                                speculate_ngram=1)
        outs = {}
        for k in (0, 4):
            reset_counts(counts)
            outs[k], bat = run_batcher(dataclasses.replace(c, speculate_k=k),
                                       params, prompts, [30] * 4, n_slots=2,
                                       max_seq=max_seq)
            n = read_counts(counts)["flash_attention_decode_paged"]
            check(n == bat.steps * L, f"gemma3 spec [{kv}, k {k}] B1 "
                  f"launches {n} != steps {bat.steps} x {L}")
            empty_index(bat)
        sp = bat.stats()["speculation"]
        check(outs[4] == outs[0], f"gemma3 [{kv}] speculative {outs[4]} != "
              f"plain {outs[0]}")
        check(sp["verify_steps"] > 0 and sp["accepted"] > 0,
              f"gemma3 [{kv}] no draft accepted: {sp}")
        print(f"gemma3 smoke exactness [speculate_k 4, {kv} pools]: 4 "
              f"requests token-identical to plain decode; {bat.steps} steps "
              f"({sp['verify_steps']} verify), drafted {sp['drafted']}, "
              f"accepted {sp['accepted']}, ring {bat.n_blocks['local']} "
              f"pages; B1 launches {n} = steps x {L}")
    print(f"gemma3 smoke exactness: one request of {plens[2]} + 6 tokens "
          f"held {peak} pages at its peak (ring + global table: {bound})")
    del params
    torch.cuda.empty_cache()


# gemma3-12b at full width: 8 slots, max_seq 2048, page 16, chunk 128;
# 16 requests of 1100-1500 prompt tokens (past the 1024 window, so the
# local ring wraps during prefill and decode), MAX_NEW new tokens each.
# Depth cut to G3_LAYERS of 48 (2 of the 8 local/global groups; widths,
# window, ring and traffic unchanged) to keep the whole run in time.
G3_MAX_SEQ, G3_PLENS, G3_LAYERS = 2048, (1100, 1501), 12


def phase_gemma3_full_width(seed):
    """gemma3-12b at full width and ``G3_LAYERS`` layers, random bf16
    weights from the seed, ``decode_flash``: the traffic above served
    paged (B1 with the ring's ``page_base`` on 10 local layers, flat on 2
    global), paged with ``speculate_k`` 4 and the single-token drafter
    (verify spans at sq = 5; the ring 66 pages), and from dense slots (B3
    on the rolled window of 1024 and the flat 2048); launches = steps x
    12 in each, the local
    group's peak pages within 8 x the ring's width; one decode step's
    logits through the kernels vs the plain path, paged and dense, and
    each one's time split.  Returns {path: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.models.cache_layouts import ring_blocks
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.serve_loop import make_paged_decode_step
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = dataclasses.replace(get("gemma3-12b"), decode_flash=True,
                               n_layers=G3_LAYERS)
    t = time.perf_counter()
    params = registry.init(base, seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in PP.tree_leaves(params))
    print(f"full width: gemma3-12b, {base.n_layers} layers, {n_params} bf16 "
          "parameters "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card) drawn "
          f"in {time.perf_counter() - t:.2f}s")
    counts = kernel_counts()
    L = base.n_layers
    rng = np.random.default_rng(seed + 12)
    prompts = [rng.integers(0, base.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(*G3_PLENS, N_REQ)]
    paged = dataclasses.replace(base, kv_page_size=PAGE, prefill_chunk=CHUNK)
    spec = dataclasses.replace(paged, speculate_k=SPEC_K, speculate_ngram=1)
    # the default local pool is exactly the 8 rings, all held once every
    # prompt is past the window, which leaves a verify span no scratch
    # page there; the last run gives each slot 2 more (a span of 5 tokens
    # touches at most 2 pages).
    scratch = {"local": N_SLOTS * (ring_blocks(base.sliding_window + SPEC_K,
                                               PAGE) + 2)}
    paths, outs = {}, {}
    for label, cfg, pool in (
            ("paged", paged, None), ("paged, speculate_k 4", spec, None),
            ("dense", base, None),
            ("paged, speculate_k 4, 2 scratch pages per slot", spec,
             scratch)):
        summary, launches, bat, outs[label] = serve_full_width(
            cfg, params, seed, counts, prompts, max_seq=G3_MAX_SEQ,
            n_pages=pool)
        kernel = ("flash_attention_decode_paged" if bat.paged
                  else "flash_attention_decode")
        check(launches[kernel] == bat.steps * L,
              f"gemma3 [{label}] {kernel} launches {launches[kernel]} != "
              f"steps {bat.steps} x {L}")
        if bat.paged:
            ring = bat.n_blocks["local"]
            check(ring == (66 if cfg.speculate_k else 65),
                  f"gemma3 [{label}] ring of {ring} pages")
            # the rings, and a verify span's scratch where the pool has it.
            bound = N_SLOTS * ring if pool is None else pool["local"]
            check(summary["peak_pages_by_group"]["local"] <= bound,
                  f"gemma3 [{label}] local pages {summary} beyond the "
                  f"rings ({bound})")
        if cfg.speculate_k:
            check(summary["speculation"]["verify_steps"] > 0,
                  f"gemma3 [{label}] no verify step: {summary}")
            summary["drafts_possible"] = drafts_possible(prompts,
                                                         outs["paged"])
        print(f"full-width serve [gemma3-12b, {label}]: "
              + json.dumps(summary))
        paths[f"gemma3-12b {label}"] = launches
        del bat
        torch.cuda.empty_cache()

    def identity(a, b):
        same = sum(x == y for x, y in zip(outs[a], outs[b]))
        share = np.mean([x == y for u, v in zip(outs[a], outs[b])
                         for x, y in zip(u, v)])
        return f"{same} of {N_REQ} requests, {share:.4f} of tokens"

    print("full-width gemma3-12b, token identity to the paged run (bf16: "
          "other GEMM shapes may flip a rounding; reported, not held): "
          + "; ".join(f"{k} {identity(k, 'paged')}" for k in outs
                      if k != "paged"))

    # one paged decode step: logits through B1 vs the plain path, and
    # its time split, on pools prefilled at 1100-1500 positions.
    pools, bt, state, _, _ = prefill_pools(paged, params, rng, G3_MAX_SEQ,
                                           G3_PLENS)
    last_tok, pos = state[0], state[1]
    compare_logits(paged, params, {"pages": pools, "block_tab": bt},
                   last_tok, pos, "gemma3-12b paged")
    step = make_paged_decode_step(paged, G3_MAX_SEQ, PAGE)
    active = torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)
    rem = state[2] + 1000

    def paged_once():
        *_, out = step(params, pools, bt, last_tok, pos, rem, active)
        out.cpu()

    paged_once()
    prof = {"paged_decode_step": profile_window(paged_once, 5)}
    del pools, step, state
    torch.cuda.empty_cache()

    # one dense decode step: 8 slots admitted at 1100-1500 positions.
    bat = ContinuousBatcher(base, params, n_slots=N_SLOTS,
                            max_seq=G3_MAX_SEQ, device=DEVICE)
    for i, plen in enumerate(rng.integers(*G3_PLENS, N_SLOTS)):
        bat.requests.Push(Request(rid=i, prompt=rng.integers(
            0, base.vocab_size, int(plen)).astype(np.int32), max_new=4))
    bat.admit()
    check(all(r is not None for r in bat._slot_req), "slots not filled")
    compare_logits(base, params, bat.cache, bat.last_tok, bat.pos,
                   "gemma3-12b dense")
    dpos, drem = bat.pos.clone(), bat.remaining + 1000

    def dense_once():
        *_, out = bat._step(params, bat.cache, bat.last_tok, dpos, drem,
                            active)
        out.cpu()

    dense_once()
    prof["dense_decode_step"] = profile_window(dense_once, 5)
    print("time split [gemma3-12b] (8 slots at 1100-1500 positions): "
          + json.dumps(prof))
    del bat, params
    torch.cuda.empty_cache()
    print(f"full-width gemma3-12b phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# --- the moe family: phi3.5-moe and deepseek (MLA latent pages) ----------------------------


def phase_moe_exactness(seed):
    """phi3.5-moe and deepseek-v2-lite at smoke width (2 layers, fp32
    compute, bf16 caches) on the card, weights drawn on the host from the
    seed: phi3.5 paged through B1 gives its dense slots' tokens through
    B3, each launched steps x layers; deepseek on latent pages gives its
    dense slots' tokens, a prefix hit the cold run's, speculative decode
    (``speculate_k`` 4) plain decode's, and a pool small enough to
    preempt the unpreempted run's; per-row capacity: 12 dense slots at
    capacity factor 0.05 (a shared step would drop copies, 24 over 4
    experts at 8 each) give each request's tokens served alone."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher
    t_phase = time.perf_counter()
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 30)
    plens, max_news = [5, 12, 21], [8, 6, 8]
    for arch in ("phi3p5-moe-42b", "deepseek-v2-lite-16b"):
        base = dataclasses.replace(smoke_variant(get(arch)),
                                   decode_flash=True)
        params = PP.tree_map(lambda _, a: a.to(DEVICE),
                             registry.init(base, seed, device="cpu"))
        L = base.n_layers
        prompts = [rng.integers(0, base.vocab_size, n).astype(np.int32)
                   for n in plens]
        reset_counts(counts)
        dense, bat = run_batcher(base, params, prompts, max_news, n_slots=2,
                                 max_seq=48)
        n = read_counts(counts)
        b3 = 0 if base.mla else bat.steps * L
        check(not bat.paged and n["flash_attention_decode"] == b3,
              f"{arch} dense B3 launches {n} != {b3}")
        reset_counts(counts)
        paged = dataclasses.replace(base, kv_page_size=8)
        got, bat = run_batcher(paged, params, prompts, max_news, n_slots=2,
                               max_seq=48, prefill_chunk=32)
        n = read_counts(counts)
        b1 = 0 if base.mla else bat.steps * L
        check(got == dense, f"{arch} paged {got} != dense {dense}")
        check(n["flash_attention_decode_paged"] == b1,
              f"{arch} paged B1 launches {n} != {b1}")
        empty_index(bat)
        print(f"moe smoke exactness [{arch}]: paged "
              f"({'/'.join(g.name for g in bat.layout.groups)} pages) == "
              f"dense slots, {bat.steps} paged steps, B1 {b1} / B3 {b3} "
              "launches = steps x layers (none on MLA)")
        if not base.mla:
            del params
            continue
        # deepseek's latent pages: prefix hit == cold, spec == plain,
        # preempt/resume == never preempted.
        P = rng.integers(0, base.vocab_size, 24).astype(np.int32)
        pcfg = dataclasses.replace(paged, prefix_cache=True)
        bat = ContinuousBatcher(pcfg, params, n_slots=2, max_seq=64,
                                device=DEVICE)
        cold, hit = serve_seq(bat, [P, P], 5)
        check(hit == cold and bat.prefix_hits == 1,
              f"deepseek prefix hit {hit} != cold {cold} "
              f"({bat.prefix_hits} hits)")
        empty_index(bat)
        mp = motif_prompts([9, 14, 6, 12], base.vocab_size,
                           np.random.default_rng(seed + 31))
        c = dataclasses.replace(paged, prefill_chunk=8, speculate_ngram=1)
        outs = {}
        for k in (0, 4):
            outs[k], bat = run_batcher(dataclasses.replace(c, speculate_k=k),
                                       params, mp, [16] * 4, n_slots=2,
                                       max_seq=48)
            empty_index(bat)
        sp = bat.stats()["speculation"]
        check(outs[4] == outs[0] and sp["drafted"] > 0,
              f"deepseek spec {outs[4]} != plain {outs[0]} ({sp})")
        big, _ = run_batcher(c, params, mp, [14, 12, 14, 10], n_slots=2,
                             max_seq=48)
        small, bat = run_batcher(c, params, mp, [14, 12, 14, 10], n_slots=2,
                                 max_seq=48, n_pages=5)
        check(bat.preemptions > 0 and small == big,
              f"deepseek preempted {small} != unpreempted {big} "
              f"({bat.preemptions} preemptions)")
        empty_index(bat)
        print(f"moe smoke exactness [deepseek latent pages]: prefix hit == "
              f"cold; speculate_k 4 == plain (drafted {sp['drafted']}, "
              f"accepted {sp['accepted']}); a 5-page pool "
              f"({bat.preemptions} preemptions) == unpreempted")
        del params

    # per-row capacity on dense slots.
    base = dataclasses.replace(smoke_variant(get("phi3p5-moe-42b")),
                               capacity_factor=0.05, decode_flash=True)
    params = PP.tree_map(lambda _, a: a.to(DEVICE),
                         registry.init(base, seed, device="cpu"))
    prompts = [rng.integers(0, base.vocab_size, 12).astype(np.int32)
               for _ in range(12)]
    max_news = [3 + i % 5 for i in range(12)]
    got, bat = run_batcher(base, params, prompts, max_news, n_slots=12,
                           max_seq=32)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        alone, _ = run_batcher(base, params, [p], [m], n_slots=1, max_seq=32)
        check(got[i] == alone[0], f"per-row capacity: request {i} on 12 "
              f"slots {got[i]} != alone {alone[0]}")
    print(f"moe smoke exactness [per-row capacity]: 12 requests on 12 dense "
          f"slots (capacity factor 0.05, {bat.steps} steps) == each served "
          f"alone on one slot")
    del params
    torch.cuda.empty_cache()
    print(f"moe smoke exactness phase: {time.perf_counter() - t_phase:.1f}s")


# the time split of a moe-family (or musicgen) decode step: the kernels
# launched inside these functions of ``models/layers.py`` (other than
# matrix products) are MoE dispatch and combine, MLA glue, or musicgen's
# cross-attention glue.
MOE_RANGES = {"_moe_dispatch": "moe_dispatch_combine",
              "_moe_combine": "moe_dispatch_combine",
              "mla_apply": "mla_glue", "mla_apply_paged": "mla_glue",
              "cross_attention_apply": "cross_attention_glue"}


def profile_classes(fn, n: int):
    """``profile_window`` of ``fn``, plus the device time per call split
    as attention kernel (B1/B3) / matmul / MoE dispatch and combine / MLA
    glue / cross-attention glue / other: each kernel is charged to the class of the innermost
    ``MOE_RANGES`` function it was launched in (a ``record_function``
    range around each, set only for the profiled calls).  The profiler
    links kernels launched through the C interface (B1, B3) to no host
    event, so their time is ``profile_window``'s, from the device
    timeline by kernel name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers
    out = profile_window(fn, n)
    saved = {name: getattr(layers, name) for name in MOE_RANGES}

    def ranged(name, f):
        def g(*a, **kw):
            with record_function(f"moe_range::{name}"):
                return f(*a, **kw)
        return g

    for name, f in saved.items():
        setattr(layers, name, ranged(name, f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
    finally:
        for name, f in saved.items():
            setattr(layers, name, f)
    gemm = dict(SPLIT)["matmul"]
    split = dict.fromkeys(("matmul", "moe_dispatch_combine", "mla_glue",
                           "cross_attention_glue", "other"), 0.0)
    for ev in prof.events():
        if not getattr(ev, "kernels", None):
            continue
        cls, p = None, ev
        while p is not None and cls is None:
            if p.name.startswith("moe_range::"):
                cls = MOE_RANGES[p.name.split("::", 1)[1]]
            p = p.cpu_parent
        for k in ev.kernels:
            key = ("matmul" if any(pat in k.name for pat in gemm)
                   else cls or "other")
            split[key] += k.duration
    if not sum(split.values()) or "matmul_ms" not in out:
        out["split_ms"] = "not measured"
        return out
    out["split_ms"] = {"attention_kernel": out["B1_flash_decode_paged_ms"]
                       + out["B3_flash_decode_ms"],
                       **{k: v / n / 1e3 for k, v in split.items()}}
    return out


@contextlib.contextmanager
def count_moe_drops():
    """Count the expert copies MoE dispatch drops at capacity, on the
    device (no host read until the end); yields a function giving the
    dropped share of all copies routed."""
    from repro_torch.models import layers
    inner = layers._moe_dispatch
    tally = torch.zeros(2, dtype=torch.int64, device=DEVICE)

    def counted(*a, **kw):
        disp, meta = inner(*a, **kw)
        keep = meta[2]
        tally[0] += keep.numel()
        tally[1] += keep.numel() - keep.sum()
        return disp, meta

    layers._moe_dispatch = counted
    try:
        yield lambda: (tally[1] / tally[0].clamp(min=1)).item()
    finally:
        layers._moe_dispatch = inner


# phi3.5-moe at full widths: 16 of its 32 layers (41.88 B parameters in
# all, 83.8 GB in bf16, leave no room for a KV pool on one 80 GB card).
# deepseek-v2-lite at full widths: 14 of its 27 layers (its dense first
# layer and 13 MoE layers), to keep the whole run in time.
PHI_LAYERS, DS_LAYERS = 16, 14


def phase_moe_full_width(seed):
    """deepseek-v2-lite-16b at full widths with ``DS_LAYERS`` layers and
    phi3.5-moe at full widths with ``PHI_LAYERS`` layers, random bf16
    weights from the seed, the minitron cell's traffic (16 requests of
    256-512 prompt tokens, 64 new, 8 slots, max_seq 1024, page 16, chunk
    128): each served paged (phi3.5 with ``decode_flash``: B1) and from
    dense slots (phi3.5: B3), B1 / B3 launched steps x 16 exactly; per
    serve tokens/s, the median decode step, TTFT, peak memory and pages;
    per model one paged and one dense decode step profiled (launches,
    idle share, the device time split by ``profile_classes``), the share
    of expert copies dropped at capacity per serve, phi3.5's
    step logits through the kernels vs the plain path (reported, not
    held: top-k routing amplifies one-ulp differences), and
    paged-vs-dense token identity as a share.  Returns {path:
    launches}."""
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from repro_torch.serve.serve_loop import make_paged_decode_step
    t_phase = time.perf_counter()
    counts = kernel_counts()
    paths = {}
    for arch, n_layers in (("deepseek-v2-lite-16b", DS_LAYERS),
                           ("phi3p5-moe-42b", PHI_LAYERS)):
        torch.cuda.empty_cache()
        base = dataclasses.replace(get(arch), decode_flash=True)
        if n_layers:
            base = dataclasses.replace(base, n_layers=n_layers)
        t = time.perf_counter()
        params = registry.init(base, seed, device=DEVICE,
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in PP.tree_leaves(params))
        print(f"full width: {arch}, {base.n_layers} layers, {n_params} bf16 "
              f"parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB on "
              f"the card) drawn in {time.perf_counter() - t:.2f}s")
        L = base.n_layers
        paged = dataclasses.replace(base, kv_page_size=PAGE,
                                    prefill_chunk=CHUNK)
        outs = {}
        for label, cfg in (("paged", paged), ("dense", base)):
            with count_moe_drops() as drops:
                summary, launches, bat, outs[label] = serve_full_width(
                    cfg, params, seed, counts)
            summary["moe_copies_dropped_share"] = drops()
            kernel = ("flash_attention_decode_paged" if bat.paged
                      else "flash_attention_decode")
            want = 0 if base.mla else bat.steps * L
            check(launches[kernel] == want, f"{arch} [{label}] {kernel} "
                  f"launches {launches[kernel]} != {want}")
            print(f"full-width serve [{arch}, {label}]: "
                  + json.dumps(summary))
            paths[f"{arch} {label}"] = launches
            del bat
            torch.cuda.empty_cache()
        same = sum(x == y for x, y in zip(outs["paged"], outs["dense"]))
        share = float(np.mean([x == y for u, v in zip(outs["paged"],
                                                       outs["dense"])
                               for x, y in zip(u, v)]))
        print(f"full-width {arch}, paged vs dense token identity (bf16: MoE "
              f"routing and GEMM shapes may flip a rounding; reported, not "
              f"held): {same} of {N_REQ} requests, {share:.4f} of tokens")

        # one paged decode step on pools prefilled at 100-900 positions.
        rng = np.random.default_rng(seed + 40)
        pools, bt, state, _, _ = prefill_pools(paged, params, rng)
        last_tok, pos = state[0], state[1]
        if not base.mla:
            compare_logits(paged, params, {"pages": pools, "block_tab": bt},
                           last_tok, pos, f"{arch} paged, not held",
                           hold=False)
        step = make_paged_decode_step(paged, MAX_SEQ, PAGE)
        active = torch.ones(N_SLOTS, dtype=torch.bool, device=DEVICE)
        rem = state[2] + 1000

        def paged_once():
            *_, out = step(params, pools, bt, last_tok, pos, rem, active)
            out.cpu()

        paged_once()
        prof = {"paged_decode_step": profile_classes(paged_once, 5)}
        del pools, step, state
        torch.cuda.empty_cache()

        # one dense decode step: 8 slots admitted at 100-900 positions.
        bat = ContinuousBatcher(base, params, n_slots=N_SLOTS,
                                max_seq=MAX_SEQ, device=DEVICE)
        for i, plen in enumerate(rng.integers(100, 900, N_SLOTS)):
            bat.requests.Push(Request(rid=i, prompt=rng.integers(
                0, base.vocab_size, int(plen)).astype(np.int32), max_new=4))
        bat.admit()
        check(all(r is not None for r in bat._slot_req), "slots not filled")
        if not base.mla:
            compare_logits(base, params, bat.cache, bat.last_tok, bat.pos,
                           f"{arch} dense, not held", hold=False)
        dpos, drem = bat.pos.clone(), bat.remaining + 1000

        def dense_once():
            *_, out = bat._step(params, bat.cache, bat.last_tok, dpos, drem,
                                active)
            out.cpu()

        dense_once()
        prof["dense_decode_step"] = profile_classes(dense_once, 5)
        print(f"time split [{arch}] (8 slots at 100-900 positions): "
              + json.dumps(prof))
        del bat, params
        torch.cuda.empty_cache()
    print(f"full-width moe phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# --- the vlm and audio families: paligemma-3b and musicgen-medium -------------------------


def vlm_audio_prompt(cfg, b, plen, rng):
    """A prompt batch as the reference's ``registry.make_batch`` makes it,
    as tensors on the host: ``plen`` text tokens (audio: (b, plen, K)
    codebook frames) and N(0, 1) bf16 rows, the vlm's
    ``vision_patches`` patch embeddings or the audio's ``cond_len``
    conditioning rows."""
    shape = (b, plen) + ((cfg.n_codebooks,) if cfg.family == "audio"
                         else ())
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int64))}
    key, rows, width = (("patches", cfg.vision_patches, cfg.vision_dim)
                        if cfg.family == "vlm"
                        else ("cond", cfg.cond_len, cfg.d_model))
    batch[key] = torch.from_numpy(rng.standard_normal(
        (b, rows, width)).astype(np.float32)).to(torch.bfloat16)
    return batch


def phase_vlm_audio_exactness(seed):
    """paligemma-3b (vlm) and musicgen-medium (audio) at smoke width (2
    layers, fp32 compute, bf16 caches) on the card, weights drawn on the
    host from the seed: ``greedy_generate`` with ``decode_flash`` (B3)
    gives the plain decode's tokens, B3 launched decode steps x layers
    (musicgen's cross-attention launches none) and not at all without
    it; the decode tokens equal the argmax of the train forward over
    prompt + generated tokens at each position (offset by the patches
    for the vlm); the batcher refuses both families."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.serve_loop import greedy_generate
    t_phase = time.perf_counter()
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 50)
    steps, plen = 8, 7
    for arch in ("paligemma-3b", "musicgen-medium"):
        base = smoke_variant(get(arch))
        params = PP.tree_map(lambda _, a: a.to(DEVICE),
                             registry.init(base, seed, device="cpu"))
        prompt = vlm_audio_prompt(base, 2, plen, rng)
        off = base.vision_patches
        toks = {}
        for flash in (False, True):
            reset_counts(counts)
            toks[flash] = greedy_generate(
                dataclasses.replace(base, decode_flash=flash), params,
                prompt, steps=steps, max_seq=off + plen + steps + 2,
                device=DEVICE)
            n = read_counts(counts)["flash_attention_decode"]
            want = steps * base.n_layers if flash else 0
            check(n == want, f"{arch} decode_flash={flash}: B3 launches "
                  f"{n} != {want}")
        check(np.array_equal(toks[True], toks[False]),
              f"{arch}: B3 tokens {toks[True].tolist()} != plain "
              f"{toks[False].tolist()}")
        batch = {k: v.to(DEVICE) for k, v in prompt.items()}
        batch["tokens"] = torch.cat([batch["tokens"], torch.from_numpy(
            toks[True]).to(DEVICE).long()], dim=1)
        logits = registry.forward(base, params, batch, mode="train")
        first = off + plen - 1
        forced = logits[:, first:first + steps].argmax(-1).cpu().numpy()
        check(np.array_equal(forced, toks[True]),
              f"{arch}: decode {toks[True].tolist()} != teacher-forced "
              f"argmax {forced.tolist()}")
        try:
            ContinuousBatcher(base, params, n_slots=2, max_seq=32,
                              device=DEVICE)
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        check(refused == "batcher demo covers LM families",
              f"{arch}: the batcher did not refuse the {base.family} family")
        print(f"vlm/audio smoke exactness [{arch}]: tokens {toks[True].shape}"
              f" through B3 == plain decode, B3 launches {steps} steps x "
              f"{base.n_layers} layers, == teacher-forced argmax, batcher "
              "refuses")
        del params
    torch.cuda.empty_cache()
    print(f"vlm/audio smoke exactness phase: "
          f"{time.perf_counter() - t_phase:.1f}s")


@contextlib.contextmanager
def timed_sampling_steps():
    """Time each prefill and decode call that ``greedy_generate`` makes,
    on the host clock up to a synchronize (the loop copies each step's
    tokens to the host anyway); yields {"prefill": [s], "decode": [s]}."""
    from repro_torch.serve import serve_loop
    inner = serve_loop.make_sampling_serve_steps
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def g(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return g

    def make(*a, **kw):
        pre, dec = inner(*a, **kw)
        return timed(pre, "prefill"), timed(dec, "decode")

    serve_loop.make_sampling_serve_steps = make
    try:
        yield times
    finally:
        serve_loop.make_sampling_serve_steps = inner


def generate_full_width(cfg, params, prompt, steps, counts, label):
    """One ``greedy_generate`` batch at ``VA_MAX_SEQ``: kernel counts set
    to 0 just before and read just after, B3 launched steps x layers,
    the tokens' shape and range held; prints tokens/s (frames/s for
    audio), the prefill time (the batch's TTFT), the median decode step
    and peak memory.  Returns the launches."""
    from repro_torch.serve.serve_loop import greedy_generate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counts)
    with timed_sampling_steps() as times:
        t0 = time.perf_counter()
        out = greedy_generate(cfg, params, prompt, steps=steps,
                              max_seq=VA_MAX_SEQ, device=DEVICE)
        wall = time.perf_counter() - t0
    launches = read_counts(counts)
    b = prompt["tokens"].shape[0]
    audio = cfg.family == "audio"
    want = (b, steps) + ((cfg.n_codebooks,) if audio else ())
    check(out.shape == want and (out >= 0).all()
          and (out < cfg.padded_vocab).all(),
          f"{label}: tokens {out.shape}, range [{out.min()}, {out.max()}]")
    n = launches["flash_attention_decode"]
    check(n == steps * cfg.n_layers,
          f"{label}: B3 launches {n} != {steps} steps x {cfg.n_layers}")
    summary = {"batch": b, "new": steps, "wall_s": wall,
               ("frames_per_s" if audio else "tokens_per_s"): b * steps / wall,
               "prefill_s": times["prefill"][0],
               "median_decode_step_ms":
                   statistics.median(times["decode"]) * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "B3_launches": n}
    if audio:
        summary["tokens_per_s"] = b * steps * cfg.n_codebooks / wall
    print(f"full-width generate [{label}]: " + json.dumps(summary))
    return launches


def profile_generate_step(cfg, params, prompt, pos, label):
    """Prefill ``prompt`` at ``VA_MAX_SEQ``, then one decode step at
    ``pos`` (every row): its logits through B3 vs the plain path
    (``compare_logits``) and its time split (``profile_classes``)."""
    from repro_torch.serve.serve_loop import make_sampling_serve_steps
    pre, dec = make_sampling_serve_steps(cfg, VA_MAX_SEQ)
    batch = {k: v.to(DEVICE) for k, v in prompt.items()}
    b, s = batch["tokens"].shape[:2]
    s += cfg.vision_patches if cfg.family == "vlm" else 0
    nxt, cache = pre(params, batch, torch.full((b,), s - 1, device=DEVICE))
    extras = {k: v for k, v in batch.items() if k == "cond"}
    pos = torch.full((b,), pos, dtype=torch.int32, device=DEVICE)
    compare_logits(cfg, params, cache, nxt, pos, label, inputs=extras)
    step_in = {"tokens": nxt.reshape((b, 1) + nxt.shape[1:]).long(),
               **extras}

    def once():
        tok, _ = dec(params, cache, step_in, pos)
        tok.cpu()

    once()
    return profile_classes(once, 5)


# the vlm and audio cells: 8 rows a batch, max_seq 512.  paligemma: 256
# patches + VLM_TEXT text tokens (one batch each), VLM_NEW new tokens;
# musicgen: AUDIO_PROMPT frames of 4 codebooks, AUDIO_NEW new frames
# (about 5 s of audio at EnCodec's 50 Hz).
VA_BATCH, VA_MAX_SEQ = 8, 512
VLM_TEXT, VLM_NEW = (64, 128), 64
AUDIO_PROMPT, AUDIO_NEW = 8, 256


def phase_vlm_audio_full_width(seed):
    """paligemma-3b and musicgen-medium at full width and full depth
    (nothing cut), random bf16 weights from the seed, ``decode_flash``,
    generated through ``greedy_generate`` (the batcher refuses both, as
    the reference's does): paligemma two batches of 8 (256 N(0, 1) bf16
    patches of 1152 + 64 and + 128 text tokens, 64 new), musicgen one of
    8 (64 x 1536 conditioning rows, 8 frames, 256 new); per batch
    tokens/s, the prefill time, the median decode step, peak memory and
    B3's launches (steps x layers, held); per model one decode step's
    logits through B3 vs the plain path (held, ``compare_logits``) and
    its time split.  Returns {path: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 60)
    paths = {}
    for arch in ("paligemma-3b", "musicgen-medium"):
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get(arch), decode_flash=True)
        t = time.perf_counter()
        params = registry.init(cfg, seed, device=DEVICE,
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in PP.tree_leaves(params))
        print(f"full width: {arch}, {cfg.n_layers} layers, {n_params} bf16 "
              f"parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB on "
              f"the card) drawn in {time.perf_counter() - t:.2f}s")
        if cfg.family == "vlm":
            batches = [(f"{arch}, {VLM_TEXT[0]} text tokens", VLM_TEXT[0],
                        VLM_NEW),
                       (f"{arch}, {VLM_TEXT[1]} text tokens", VLM_TEXT[1],
                        VLM_NEW)]
        else:
            batches = [(arch, AUDIO_PROMPT, AUDIO_NEW)]
        for label, plen, new in batches:
            prompt = vlm_audio_prompt(cfg, VA_BATCH, plen, rng)
            paths[label] = generate_full_width(cfg, params, prompt, new,
                                               counts, label)
        # one decode step: after the longest prompt (vlm), or halfway
        # through the new frames (audio; the cache rows past the prompt
        # are zero, as many keys read as at that point of generation).
        at = (cfg.vision_patches + plen if cfg.family == "vlm"
              else plen + new // 2)
        prof = profile_generate_step(cfg, params, prompt, at, arch)
        print(f"time split [{arch}] (8 rows at position {at}): "
              + json.dumps({"decode_step": prof}))
        del params
        torch.cuda.empty_cache()
    print(f"full-width vlm/audio phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# --- training (A14) -------------------------------------------------------------------------

# losses and gradient norms of the card's smoke-width steps against the
# port's CPU run: the tolerances the CPU tests hold the port to against
# the JAX package (tests/test_torch_train_parity.py).
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GNORM_RTOL = 1e-4
# grad_accum 2 against 1 on the card: the fp32 sum of two microbatches'
# gradients, then the divide, against one batch's gradient.
ACCUM_GNORM_RTOL = 1e-4


def _bits_equal(a, b) -> bool:
    """Two training states (nested dicts and tuples of tensors) hold the
    same bits, dtypes and devices."""
    from repro_torch.train.optimizer import sorted_leaves
    la, lb = sorted_leaves(a), sorted_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(
            x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
            y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


def phase_train_exactness(seed):
    """Training at smoke width (minitron-4b, fp32), weights drawn on the
    host from the seed: the card's losses and gradient norms over 5
    steps equal the port's CPU run to the CPU tests' tolerance;
    ``grad_accum=2`` equals ``grad_accum=1``: the gradient norm to
    ACCUM_GNORM_RTOL (a dropped divide doubles it), the parameters to the
    reference's tolerance at lr 1e-3 with warmup 1, where the step moves
    an element by ~1e-3 (a lost microbatch flips signs); ``TrainSupervisor`` with failures before steps 6 and 10
    ends in the uninterrupted run's state bit for bit; a checkpoint
    round trip (bf16 parameters, fp32 moments) gives the state back bit
    for bit on the card; remat none / dots / full give the same loss and
    gradients bit for bit.  The train path launches no kernel of the
    port."""
    import tempfile
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import data as D
    from repro_torch.train import fault as F
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_loop as TL
    t_phase = time.perf_counter()
    counts = kernel_counts()
    reset_counts(counts)
    cfg = smoke_variant(get("minitron-4b"))
    host = registry.init(cfg, seed, device="cpu")
    tcfg = TL.TrainCfg(opt=OPT.OptCfg(lr=1e-3, warmup_steps=2,
                                      total_steps=10))
    dcfg = D.DataCfg(global_batch=4, seq_len=32, seed=seed)

    def batch(step, device=DEVICE, d=dcfg):
        return {k: torch.from_numpy(v).to(device)
                for k, v in D.make_batch(cfg, d, step).items()}

    def fresh(device=DEVICE):
        p = PP.tree_map(lambda _, a: a.to(device).clone(), host)
        return p, OPT.init(p)

    def run(device, steps, tc=tcfg):
        p, o = fresh(device)
        step = TL.make_train_step(cfg, tc)
        out = []
        for s in range(steps):
            p, o, m = step(p, o, batch(s, device))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return p, out

    _, on_cpu = run("cpu", 5)
    _, on_card = run(DEVICE, 5)
    for s, ((lc, gc), (lg, gg)) in enumerate(zip(on_cpu, on_card)):
        check(abs(lc - lg) < TRAIN_LOSS_ATOL
              and abs(gc - gg) <= TRAIN_GNORM_RTOL * abs(gc),
              f"train step {s}: card loss {lg} / norm {gg} != CPU {lc} / "
              f"{gc}")
    print("train smoke exactness: 5 steps, card vs CPU (loss, grad norm): "
          + json.dumps({"cpu": on_cpu, "card": on_card}))

    one = batch(0)
    acc = {}
    for n in (1, 2):
        p, o = fresh()
        p, o, m = TL.make_train_step(cfg, TL.TrainCfg(
            opt=OPT.OptCfg(lr=1e-3, warmup_steps=1, total_steps=10),
            grad_accum=n, compress_grads=False))(p, o, one)
        acc[n] = (p, float(m["loss"]), float(m["grad_norm"]))
    pairs = list(zip(OPT.sorted_leaves(acc[1][0]),
                     OPT.sorted_leaves(acc[2][0])))
    worst = max((a - b).abs().max().item() for a, b in pairs)
    moved = max((a - h.to(DEVICE)).abs().max().item() for a, h in
                zip(OPT.sorted_leaves(acc[1][0]), OPT.sorted_leaves(host)))
    gnorm_rel = abs(acc[2][2] - acc[1][2]) / acc[1][2]
    check(abs(acc[1][1] - acc[2][1]) < 5e-3 and gnorm_rel <= ACCUM_GNORM_RTOL
          and moved > 5e-4
          and all(torch.allclose(a, b, rtol=2e-2, atol=2e-4)
                  for a, b in pairs),
          f"grad_accum 2 vs 1: loss {acc[2][1]} vs {acc[1][1]}, grad norm "
          f"{acc[2][2]} vs {acc[1][2]}, params differ by {worst}, the "
          f"step moved them by {moved}")

    step = TL.make_train_step(cfg, TL.TrainCfg())

    def wrapped(state, b):
        p, o, m = step(*state, b)
        return (p, o), m

    sup_dcfg = D.DataCfg(global_batch=2, seq_len=16, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        sups = {}
        for label, fail_at in (("uninterrupted", ()), ("fail 6, 10", (6, 10))):
            sup = F.TrainSupervisor(wrapped, fresh(),
                                    os.path.join(tmp, label), save_every=4)
            rep = sup.run(lambda s: batch(s, d=sup_dcfg), num_steps=12,
                          fail_at=fail_at)
            sups[label] = (sup.state, rep)
        rep = sups["fail 6, 10"][1]
        check(rep.restarts == 2 and rep.steps_run == 16,
              f"supervisor: {rep.restarts} restarts, {rep.steps_run} steps")
        check(_bits_equal(sups["fail 6, 10"][0], sups["uninterrupted"][0]),
              "supervisor: the state after failures at 6 and 10 differs "
              "from the uninterrupted run's")

        p = PP.tree_map(lambda _, a: a.to(torch.bfloat16), fresh()[0])
        state = {"params": p, "opt": OPT.init(p)}
        state["opt"].m["embed"].normal_()
        CK.save(os.path.join(tmp, "rt"), 3, state)
        back, at, _ = CK.restore(os.path.join(tmp, "rt"), state)
        check(at == 3 and _bits_equal(back, state),
              "checkpoint round trip changed the state")

    rb = registry.make_batch(cfg, "train", 2, 32, seed=seed, device=DEVICE)
    grads = {r: TL.value_and_grad(dataclasses.replace(cfg, remat=r),
                                  fresh()[0], rb)
             for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        check(torch.equal(grads[r][0], grads["none"][0])
              and _bits_equal(grads[r][1], grads["none"][1]),
              f"remat {r}: loss or gradients differ from remat none")
    launched = read_counts(counts)
    check(not any(launched.values()),
          f"the train path launched kernels of the port: {launched}")
    print(f"train smoke exactness: grad_accum 2 == 1 (grad norm "
          f"{acc[2][2]} vs {acc[1][2]}, relative {gnorm_rel:.3g}; params "
          f"within {worst:.3g} of a step of {moved:.3g}), supervisor with failures at 6 and 10 == "
          "uninterrupted (2 restarts, bit for bit), checkpoint round trip "
          "bit for bit (bf16 params), remat none == dots == full bit for "
          f"bit; {time.perf_counter() - t_phase:.1f}s")


# the full-width training cell: minitron-4b, batch 1 x seq 1024, bf16
# weights and gradients, fp32 moments, remat "dots", 4 steps.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "minitron-4b", 1, 1024, 4
# the card's memory the reckoning may plan for (the rest: the allocator's
# slack and the CUDA context).
TRAIN_MEM_SHARE = 0.92


def train_memory_gb(cfg, n_layers, b, s):
    """The bytes a full-width step needs at its peak, from the shapes:
    bf16 parameters and gradients, fp32 moments, the matmul outputs
    remat "dots" keeps per layer (q, k, v, wo, gate, up, down) with the
    layer's input, the bf16 logits and their fp32 copy, and the fp32
    logits' gradient with its bf16 cast."""
    from repro_torch.models import registry
    n = registry.num_params(dataclasses.replace(cfg, n_layers=n_layers))
    tok = b * s
    kv = cfg.n_kv_heads * cfg.head_dim
    layer = 2 * tok * (cfg.n_heads * cfg.head_dim + 2 * kv + cfg.d_model
                       + 2 * cfg.d_ff + cfg.d_model + cfg.d_model)
    logits = tok * cfg.padded_vocab * (2 + 4 + 4 + 2)
    return {"params": 2 * n / 1e9, "grads": 2 * n / 1e9,
            "moments": 8 * n / 1e9, "saved": n_layers * layer / 1e9,
            "logits": logits / 1e9}


def phase_train_full_width(seed, measured):
    """minitron-4b at full width (32 layers, d 3072, 24 / 8 heads of
    128, d_ff 9216, vocab 256 000), random bf16 weights from the seed,
    fp32 AdamW moments, remat "dots", trained 4 steps at batch 1 x seq
    1024 through ``launch.train.main`` on the card.  The memory is
    reckoned first; a depth that does not fit is cut (never a width) and
    the cut printed.  Prints per step the wall ms, loss and gradient
    norm (all finite, held), tokens/s, 6·N·tokens over the step time
    beside 989 TFLOP/s with N the parameters of the matmuls (the
    embedding table left out), peak memory, and one profiled step's device busy
    ms and its split: matmul / blocked attention (forward, recompute and
    backward, from ``record_function`` ranges) / optimizer / other."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get
    from repro_torch.launch import train as LT
    from repro_torch.models import layers
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_loop as TL
    t_phase = time.perf_counter()
    counts = kernel_counts()
    gc.collect()                 # what earlier phases left unreferenced
    torch.cuda.empty_cache()
    cfg = get(TRAIN_ARCH)
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    depth = cfg.n_layers
    while sum(train_memory_gb(cfg, depth, TRAIN_BATCH, TRAIN_SEQ).values()) \
            > TRAIN_MEM_SHARE * total:
        depth -= 1
    need = train_memory_gb(cfg, depth, TRAIN_BATCH, TRAIN_SEQ)
    print(f"full-width training [{TRAIN_ARCH}]: memory reckoned "
          + json.dumps({k: round(v, 3) for k, v in need.items()})
          + f" = {sum(need.values()):.2f} GB of {total:.2f} GB; "
          + (f"depth cut to {depth} of {cfg.n_layers} layers (widths and "
             "vocab whole)" if depth < cfg.n_layers else
             f"all {cfg.n_layers} layers"))
    run_cfg = dataclasses.replace(cfg, n_layers=depth)
    check(run_cfg.remat == "dots" and run_cfg.dtype == "bfloat16",
          f"{TRAIN_ARCH}: remat {run_cfg.remat}, dtype {run_cfg.dtype}")

    # one profiled step (the last): device time by class from ranges
    # around the blocked attention's forward / backward and the update.
    prof_out = {}
    real_make, real_get = TL.make_train_step, LT.get_arch
    real_fwd = layers.BlockedAttention.forward
    real_bwd = layers.BlockedAttention.backward
    real_update = OPT.update

    def ranged(name, f):
        def g(*a, **kw):
            with record_function(f"train_range::{name}"):
                return f(*a, **kw)
        return g

    def make_step(c, t):
        step = real_make(c, t)
        calls = [0]

        def timed(p, o, b):
            calls[0] += 1
            if calls[0] == 1:
                # the first step's parameters, for phase 12 to hold its
                # sharded step against; the digest's time is taken off
                # this step's wall below.
                out = step(p, o, b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first["digest"] = param_digest(out[0])
                first["digest_s"] = time.perf_counter() - t0
                return out
            if calls[0] < TRAIN_STEPS:
                return step(p, o, b)
            layers.BlockedAttention.forward = staticmethod(
                ranged("attention", real_fwd))
            layers.BlockedAttention.backward = staticmethod(
                ranged("attention", real_bwd))
            OPT.update = ranged("optimizer", real_update)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(p, o, b)
                    torch.cuda.synchronize()
            finally:
                layers.BlockedAttention.forward = staticmethod(real_fwd)
                layers.BlockedAttention.backward = staticmethod(real_bwd)
                OPT.update = real_update
            prof_out["prof"] = prof
            return out
        return timed

    first = {}
    TL.make_train_step = make_step
    LT.get_arch = lambda name: run_cfg
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counts)
    try:
        out = LT.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                       "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                       "--seed", str(seed), "--log-every", "1",
                       "--device", DEVICE])
    finally:
        TL.make_train_step, LT.get_arch = real_make, real_get
    peak = torch.cuda.max_memory_allocated() / 1e9
    launched = read_counts(counts)
    check(not any(launched.values()),
          f"the train path launched kernels of the port: {launched}")
    steps = out["steps"]
    steps[0]["seconds"] -= first["digest_s"]
    check(len(steps) == TRAIN_STEPS and all(
        np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
        for s in steps), f"full-width training: non-finite {steps}")
    n_params = sum(p.numel() for p in OPT.sorted_leaves(out["params"]))
    n_embed = out["params"]["embed"].numel()
    check(all(p.dtype == torch.bfloat16
              for p in OPT.sorted_leaves(out["params"])),
          "full-width training: parameters left bf16")
    del out
    torch.cuda.empty_cache()

    gemm = dict(SPLIT)["matmul"]
    split = dict.fromkeys(("matmul", "attention", "optimizer", "other"), 0.0)
    others = collections.Counter()
    n_kernels = 0
    for ev in prof_out["prof"].events():
        if not getattr(ev, "kernels", None):
            continue
        cls, p = None, ev
        while p is not None and cls is None:
            if p.name.startswith("train_range::"):
                cls = p.name.split("::", 1)[1]
            p = p.cpu_parent
        for k in ev.kernels:
            n_kernels += 1
            key = cls or ("matmul" if any(pat in k.name for pat in gemm)
                          else "other")
            split[key] += k.duration / 1e3
            if key == "other":
                others[f"{ev.name} > {k.name[:60]}"] += k.duration / 1e3
    busy = sum(split.values())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # steady steps: not the first (warm-up) and not the profiled last.
    steady = statistics.median(s["seconds"] for s in steps[1:-1])
    flops = 6 * (n_params - n_embed) * tokens
    report = {
        "card": torch.cuda.get_device_name(0), "layers": depth,
        "parameters": n_params, "embedding_parameters": n_embed,
        "matmul_parameters": n_params - n_embed,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "step_wall_ms": [s["seconds"] * 1e3 for s in steps],
        "loss": [s["loss"] for s in steps],
        "grad_norm": [s["grad_norm"] for s in steps],
        "lr": [s["lr"] for s in steps],
        "steady_step_ms": steady * 1e3, "tokens_per_s": tokens / steady,
        "model_tflop_per_s": flops / steady / 1e12,
        "share_of_989_tflop_per_s": flops / steady / PEAK_BF16,
        "peak_memory_gb": peak, "reckoned_gb": sum(need.values()),
        "profiled_step": {
            "wall_ms": steps[-1]["seconds"] * 1e3,
            "device_busy_ms": busy if busy else "not measured",
            "kernels": n_kernels,
            "split_ms": split if busy else "not measured",
            "other_top_ms": dict(others.most_common(8))},
        # the profiled step's busy time over the median unprofiled
        # step's wall: two different runs, so an estimate.
        "idle_share_estimate": 1.0 - busy / (steady * 1e3)
        if busy else "not measured"}
    print(f"full-width training [{TRAIN_ARCH}]: " + json.dumps(report))
    measured[f"{TRAIN_ARCH} train step, b {TRAIN_BATCH} x s {TRAIN_SEQ}"] = {
        "cfg": run_cfg, "shape": ("train", TRAIN_SEQ, TRAIN_BATCH),
        "ms": steady * 1e3, "device_busy_ms": busy if busy else None}
    print(f"full-width training phase: {time.perf_counter() - t_phase:.1f}s")
    return {"cfg": run_cfg, "steps": steps, "digest": first["digest"],
            "busy_ms": busy if busy else None}


def param_digest(tree) -> dict:
    """{leaf path: (sum of its bits, sum of its bits weighted by their
    position)} as int64 reckoned on the card, chunk by chunk — two trees
    of equal bits give equal digests (a DTensor leaf by its local shard,
    the whole array on a mesh of one device)."""
    from repro_torch.distributed.sharding import local
    from repro_torch.models.params import tree_map
    out = {}
    chunk = 1 << 24

    def one(path, t):
        flat = local(t).detach().reshape(-1)
        bits = flat.view({2: torch.int16, 4: torch.int32}[flat.element_size()])
        s1 = torch.zeros((), dtype=torch.int64, device=flat.device)
        s2 = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, bits.numel(), chunk):
            b = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=b.device) % 1000003 + 1
            s1 += b.sum()
            s2 += (b * w).sum()
        out["/".join(path)] = (int(s1), int(s2))
    tree_map(one, tree)
    return out


# --- phase 12: sharded training (A13a) ----------------------------------------------

# at most this long, stated before its first call on the card; the whole
# script stays under 1200 s.
SHARDED_BUDGET_S = 75
SHARDED_STEPS = 3


def phase_sharded_train(seed, unsharded, card_line):
    """The mesh path of the train step on the card: one rank, a
    world-size-1 NCCL group from a ``HashStore`` (no port opened), a
    (1, 1) ("data", "model") ``DeviceMesh("cuda")``.  The port's
    collectives and the collectives the step calls run through NCCL;
    then minitron-4b at phase 10's width and depth, from its seed and
    batches, takes ``SHARDED_STEPS`` steps through
    ``make_train_step(mesh=..., zero1=True)``: parameters as DTensors by
    ``param_specs``, moments by ``opt_specs`` (ZeRO-1), the batch sharded
    over "data".  Each step's loss and gradient norm, and a digest of
    every parameter bit after the first step, are held equal to phase
    10's unsharded steps.  Prints the sharded steps' wall ms and a
    profiled step's device busy ms beside the unsharded ones, and the
    card."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import collectives as C
    from repro_torch.distributed.sharding import is_dtensor, place_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_loop as TL
    print(f"sharded training phase: budget {SHARDED_BUDGET_S} s (the whole "
          "script within 1200 s)")
    t_phase = time.perf_counter()
    counts = kernel_counts()
    check(dist.is_nccl_available(), "sharded training: no NCCL backend")
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.randn(1 << 20, generator=gen, device=DEVICE)
        coll = {"tree_all_reduce": C.tree_all_reduce(x, mesh.get_group(
                    "data")),
                "ring_all_reduce": C.ring_all_reduce(x, mesh.get_group(
                    "model")),
                "ppermute": C.ppermute(x, None, [(0, 0)])}
        y = x.clone()
        dist.all_reduce(y)
        coll["dist.all_reduce"] = y
        z = torch.empty_like(x)
        dist.all_gather_into_tensor(z, x)
        coll["dist.all_gather_into_tensor"] = z
        w = torch.empty_like(x)
        dist.reduce_scatter_tensor(w, x)
        coll["dist.reduce_scatter_tensor"] = w
        torch.cuda.synchronize()
        for name, got in coll.items():
            check(torch.equal(got, x), f"NCCL, one rank: {name} changed "
                  "its input")
        print("sharded training: NCCL world of 1, (1, 1) mesh; "
              + ", ".join(coll) + " give their input back bit for bit "
              "(one rank: no hop of the tree or ring schedules; their hops "
              "are held on 8 gloo ranks in the CPU tests)")

        cfg = unsharded["cfg"]
        tcfg = TL.TrainCfg(opt=OPT.OptCfg(
            lr=1e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
            total_steps=TRAIN_STEPS), zero1=True)
        step_fn, (psh, osh), _ = TL.make_train_step(cfg, tcfg, mesh)
        plain = registry.init(cfg, seed, device=DEVICE,
                              dtype=torch_dtype(cfg.dtype))
        params = place_tree(plain, psh)
        del plain
        opt_state = OPT.init(params, osh.m)
        dcfg = D.DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         seed=seed)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counts)
        walls, metrics, prof = [], [], None
        for k in range(SHARDED_STEPS):
            batch = {n: torch.from_numpy(v).to(DEVICE)
                     for n, v in D.make_batch(cfg, dcfg, k).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if k == SHARDED_STEPS - 1:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    params, opt_state, m = step_fn(params, opt_state, batch)
                    torch.cuda.synchronize()
            else:
                params, opt_state, m = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if k == 0:
                digest = param_digest(params)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launched = read_counts(counts)
        check(not any(launched.values()),
              f"the sharded train path launched kernels of the port: "
              f"{launched}")
        check(all(is_dtensor(p) for p in OPT.sorted_leaves(params))
              and all(is_dtensor(t) for t in OPT.sorted_leaves(
                  (opt_state.m, opt_state.v))),
              "sharded training: a leaf left the mesh")
        zero_dims = sorted({str(t.placements)
                            for t in OPT.sorted_leaves(opt_state.m)})
        del params, opt_state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    want = [(s["loss"], s["grad_norm"]) for s in unsharded["steps"]]
    for k, (got, ref) in enumerate(zip(metrics, want)):
        check(got == ref, f"sharded step {k + 1}: (loss, grad norm) {got} "
              f"!= unsharded {ref}")
    diff = [p for p in unsharded["digest"]
            if digest.get(p) != unsharded["digest"][p]]
    check(not diff and len(digest) == len(unsharded["digest"]),
          f"sharded step 1: parameters differ from the unsharded step's in "
          f"{diff}")
    busy = sum(k.duration for ev in prof.events()
               for k in (getattr(ev, "kernels", None) or [])) / 1e3
    report = {
        "mesh": {"data": 1, "model": 1}, "backend": "nccl",
        "layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "zero1_moment_placements": zero_dims,
        "loss_grad_norm": metrics, "equal_to_unsharded": True,
        "parameter_leaves_equal": len(digest),
        "sharded_wall_ms": walls,
        "unsharded_wall_ms": [s["seconds"] * 1e3
                              for s in unsharded["steps"]][:SHARDED_STEPS],
        "sharded_profiled_busy_ms": busy if busy else "not measured",
        "unsharded_profiled_busy_ms": unsharded["busy_ms"] or "not measured",
        "peak_memory_gb": peak}
    print("sharded training [minitron-4b, (1, 1) mesh, zero1]: "
          + json.dumps(report) + f"; {card_line}")
    spent = time.perf_counter() - t_phase
    print(f"sharded training phase: {spent:.1f}s (budget "
          f"{SHARDED_BUDGET_S} s)")


# --- tiered KV memory and resilient serving (A10a, A10b) ------------------------------------


def ladder_quiet(bat, label, report=None):
    """A fault-free run must show no rung of the degradation ladder and
    no supervisor fault: a broken copy or kernel on the card would pass
    as a recompute or a restart otherwise."""
    st = bat.stats()
    check(st["tier_faults"] == 0 and not st["tier_disabled"]
          and not bat._fault.active,
          f"[{label}] fault-free run took the ladder: tier_faults "
          f"{st['tier_faults']}, tier_disabled {st['tier_disabled']}")
    if report is not None:
        check(report.faults == 0 and report.restarts == 0,
              f"[{label}] fault-free supervised run: {report}")


def phase_tier_resilience_exactness(seed):
    """Tiered KV memory and resilient serving at smoke width on the card
    (fp32 compute, bf16 or int8 pools, B1 for every decode step, every
    page movement through the staged engine's copy stream and pinned
    buffers): a T1 rehit gives the tokens of a device-resident hit and
    of a cold run; spill/restore and recompute preemption give the
    tokens of a run never preempted; a batcher restarted from a T2
    snapshot pays only the catch-up chunk, and a bit-flipped or
    truncated snapshot gives a cold start; the chaos matrix (step:2,
    chunk:2, t1_d2h:1+, t1_h2d:1+, alloc:3..5, bf16 and int8 pages)
    under the supervisor: survivors bit-identical to the fault-free run,
    only the affected request errors, every allocator consistent; a
    supervised recovery after step:2 bit-identical.  Fault-free runs
    show no tier fault and no supervisor fault or restart."""
    import tempfile
    import warnings
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    from repro_torch.serve.resilience import (InjectedFault, RequestErrored,
                                              RequestFailed, ServeSupervisor)
    t_phase = time.perf_counter()
    base = smoke_variant(get("minitron-4b"))
    params = registry.init(base, seed, device=DEVICE)
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 41)
    V = base.vocab_size

    def tier(page=8, **kw):
        kw = {"kv_host_tier_bytes": 1 << 20, "tier_restore_min_tokens": 0,
              **kw}
        return dataclasses.replace(
            base, kv_page_size=page, prefill_chunk=page, prefix_cache=True,
            decode_flash=True, **kw)

    def make(c, **kw):
        return ContinuousBatcher(c, params, device=DEVICE, **kw)

    def b1_per_step(bat, n, label):
        check(n["flash_attention_decode_paged"] == bat.steps * base.n_layers,
              f"[{label}] B1 launches {n['flash_attention_decode_paged']} "
              f"!= steps {bat.steps} x {base.n_layers}")

    # T1 rehit == device-resident hit == cold.
    P, F = (rng.integers(0, V, 32).astype(np.int32) for _ in range(2))
    for kv in ("bfloat16", "int8"):
        c = tier(kv_cache_dtype=kv)
        reset_counts(counts)
        bat = make(c, n_slots=1, max_seq=64, n_pages=6)
        cold, _, rehit = serve_seq(bat, [P, F, P], 5)
        b1_per_step(bat, read_counts(counts), f"T1 rehit, {kv}")
        t = bat._tiers.stats()
        check(t["demotions"] >= 3 and t["rehits"] >= 1,
              f"[{kv}] no demote/rehit: {t}")
        ladder_quiet(bat, f"T1 rehit, {kv}")
        dev = make(c, n_slots=1, max_seq=64)
        cold2, hit = serve_seq(dev, [P, P], 5)
        check(dev.prefix_hits == 1 and dev._tiers.rehits == 0,
              f"[{kv}] the default pool did not hit on the card")
        check(rehit == hit == cold == cold2, f"[{kv}] T1 rehit {rehit}, "
              f"device hit {hit}, cold {cold} / {cold2}")
        print(f"tiers [smoke, {kv}]: T1 rehit == device-resident hit == cold "
              f"({t['demotions']} demotions, {t['rehits']} rehits, "
              f"{t['d2h_bytes']} B down, {t['h2d_bytes']} B up)")

    # preemption: spill/restore and recompute == never preempted.
    prompts = [rng.integers(0, V, 6).astype(np.int32) for _ in range(3)]
    for kv in ("bfloat16", "int8"):
        for mode, rmin in (("spill/restore", 0), ("recompute", 10_000)):
            c = tier(page=4, kv_cache_dtype=kv, tier_restore_min_tokens=rmin)
            gold, gbat = run_batcher(c, params, prompts, [12] * 3,
                                     n_slots=3, max_seq=64)
            check(gbat.preemptions == 0, "the oracle run preempted")
            reset_counts(counts)
            got, bat = run_batcher(c, params, prompts, [12] * 3, n_slots=3,
                                   max_seq=64, n_pages=8)
            b1_per_step(bat, read_counts(counts), f"{mode}, {kv}")
            x = bat.stats()["transfers"]
            check(bat.preemptions > 0 and got == gold,
                  f"[{mode}, {kv}] {bat.preemptions} preemptions, {got} != "
                  f"never preempted {gold}")
            spills = x["gathers"] - bat._tiers.demotions  # the rest demote
            if rmin:
                check(bat.recompute_resumes == bat.resumes > 0
                      and spills == 0, f"[{mode}, {kv}] {x}")
            else:
                check(bat.recompute_resumes == 0 and spills > 0
                      and x["scatters"] > 0, f"[{mode}, {kv}] {x}")
            ladder_quiet(bat, f"{mode}, {kv}")
            print(f"tiers [smoke, {kv}]: {mode} preemption == never "
                  f"preempted ({bat.preemptions} preemptions, "
                  f"{bat.recompute_resumes} recompute resumes, transfers "
                  f"{x['gathers']}G/{x['scatters']}S)")

    # T2: a restart pays only the catch-up chunk; rot gives a cold start.
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "kv_tier.snap")
        a = make(tier(kv_tier_snapshot=snap), n_slots=2, max_seq=64)
        (cold,) = serve_seq(a, [P], 5)
        check(a.prefill_chunks == 4, f"cold chunks {a.prefill_chunks}")
        a.save_tier_snapshot()
        b = make(tier(kv_tier_snapshot=snap), n_slots=2, max_seq=64)
        loaded = b._tiers.stats()["snapshot_loaded"]
        (hit,) = serve_seq(b, [P], 5)
        check(loaded >= 4 and hit == cold and b.prefill_chunks == 1,
              f"snapshot restart: loaded {loaded}, chunks "
              f"{b.prefill_chunks}, {hit} != {cold}")
        ladder_quiet(b, "snapshot restart")
        for mangle in ("snapshot_corrupt", "snapshot_truncate"):
            os.remove(snap)
            a = make(tier(kv_tier_snapshot=snap, fault_plan=f"{mangle}:1"),
                     n_slots=2, max_seq=64)
            serve_seq(a, [P], 5)
            a.save_tier_snapshot()
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                b = make(tier(kv_tier_snapshot=snap), n_slots=2, max_seq=64)
            check(b.snapshot_cold_start and len(b._tiers.store) == 0
                  and any("cold start" in str(m.message) for m in w),
                  f"[{mangle}] no cold start")
            (again,) = serve_seq(b, [P], 5)
            check(again == cold and b.prefill_chunks == 4,
                  f"[{mangle}] cold start served {again} in "
                  f"{b.prefill_chunks} chunks")
        print("tiers [smoke]: snapshot restart == cold with 1 catch-up chunk "
              f"({loaded} entries loaded); bit-flipped and truncated "
              "snapshots give a cold start that serves the cold tokens")

    # the chaos matrix under the supervisor.
    chaos_prompts = [rng.integers(0, V, 16).astype(np.int32)
                     for _ in range(4)]

    def chaos(c, faults=None):
        bat = make(c, n_slots=2, max_seq=64, queue_depth=64, n_pages=8,
                   faults=faults)
        sup = ServeSupervisor(bat, max_restarts=2)
        reqs = [Request(rid=i, prompt=p, max_new=20)
                for i, p in enumerate(chaos_prompts)]
        for r in reqs:
            bat.submit(r)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sup.run(len(reqs))
        outs = {}
        for r in reqs:
            try:
                outs[r.rid] = (drain(r, timeout=60.0), None)
            except RequestFailed as e:
                outs[r.rid] = (e.tokens, e)
        return bat, sup, outs

    table = {}
    for kv in ("bfloat16", "int8"):
        c = tier(kv_cache_dtype=kv)
        reset_counts(counts)
        gbat, gsup, gold = chaos(c)
        n = read_counts(counts)
        b1_per_step(gbat, n, f"chaos fault-free, {kv}")
        if kv == "int8":
            want = b2_launches_expected(c, gbat)
            check({k: n[k] for k in want} == want,
                  f"int8 chaos B2 launches {n} != {want}")
        check(all(e is None for _, e in gold.values())
              and gbat.preemptions > 0 and gbat._tiers.demotions > 0,
              f"[{kv}] fault-free chaos run: {gbat.stats()}")
        ladder_quiet(gbat, f"chaos fault-free, {kv}", gsup.report)
        for site in ("step:2", "chunk:2", "t1_d2h:1+", "t1_h2d:1+",
                     "alloc:3..5"):
            reset_counts(counts)
            bat, sup, outs = chaos(c, faults=site)
            b1_per_step(bat, read_counts(counts), f"{site}, {kv}")
            check(bool(bat._fault.fired.get(site.split(":")[0])),
                  f"[{site}, {kv}] the fault never fired")
            errs = 0
            for rid, (toks, e) in outs.items():
                if e is not None:
                    errs += 1
                    check(isinstance(e, RequestErrored)
                          and isinstance(e.__cause__, InjectedFault),
                          f"[{site}, {kv}] rid {rid}: {e!r}")
                    continue
                check(toks == gold[rid][0], f"[{site}, {kv}] rid {rid} "
                      f"{toks} != fault-free {gold[rid][0]}")
            check(errs <= 1, f"[{site}, {kv}] {errs} requests errored")
            if site.startswith(("t1_", "alloc")):
                check(errs == 0 and sup.report.faults == 0,
                      f"[{site}, {kv}] the ladder killed a request")
            if site.startswith("step"):
                check(errs == 0 and sup.report.restarts == 1,
                      f"[{site}, {kv}] supervised recovery: {sup.report}")
            for alloc in bat._alloc.values():
                alloc.check_consistency()
            check(bat.retired == len(outs), "a request never ended")
            st = bat.stats()
            table[f"{site} {kv}"] = {
                "errored": errs, "restarts": sup.report.restarts,
                "tier_faults": st["tier_faults"],
                "recompute_resumes": bat.recompute_resumes}
    print("chaos matrix [smoke, card]: survivors bit-identical to the "
          "fault-free runs, allocators consistent, step:2 recovered by the "
          "supervisor bit for bit: " + json.dumps(table))
    print(f"tiers and resilience smoke phase: "
          f"{time.perf_counter() - t_phase:.1f}s")
    del params
    torch.cuda.empty_cache()


# the tiered serve: 3 rounds (families A, B, A) of 16 requests, each round
# 4 distinct 512-token system prompts shared by 4 requests each (plus
# 32-128 own tokens, 64 new); a 1 GiB host tier.
T1_BYTES = 1 << 30
TIER_POOL_SPARE = 96      # pool = live pages at peak + this (< a family)
CROSSOVER_N = (16, 32, 64, 128, 512)


def tier_family(vocab, rng):
    systems = [rng.integers(0, vocab, SYS_LEN) for _ in range(4)]
    own = [rng.integers(0, vocab, int(n)) for n in rng.integers(32, 129,
                                                                N_REQ)]
    return [np.concatenate([systems[i % 4], o]).astype(np.int32)
            for i, o in enumerate(own)]


def serve_round(bat, prompts, counts):
    """One round of requests through a live batcher under
    ``DataflowContext`` (its prefix index and host tier carry over from
    earlier rounds); kernel counts are set to 0 just before and read just
    after.  Returns (summary, launches, outputs)."""
    from repro_torch.core.dataflow import DataflowContext
    from repro_torch.serve.batching import Request, drain
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW, out=stamped_stream())
            for i, p in enumerate(prompts)]
    submitted = {}
    steps0, chunks0 = bat.steps, bat.prefill_chunks

    def producer():
        for r in reqs:
            submitted[r.rid] = time.perf_counter()
            bat.submit(r)

    reset_counts(counts)
    t0 = time.perf_counter()
    with DataflowContext() as df:
        df.function(producer, name="producer")
        df.function(bat.run, bat.retired + len(reqs), name="batcher")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    outs = [drain(r, timeout=60.0) for r in reqs]
    check(all(len(o) == MAX_NEW for o in outs), "short stream")
    steps = bat.steps - steps0
    check(launches["flash_attention_decode_paged"]
          == (bat.steps - steps0) * bat.cfg.n_layers,
          f"B1 launches {launches['flash_attention_decode_paged']} != "
          f"(decode + verify steps) {bat.steps - steps0} x layers")
    ttft = [r.out.first_at - submitted[r.rid] for r in reqs]
    return {"tokens_per_s": sum(map(len, outs)) / wall, "wall_s": wall,
            "decode_steps": steps, "chunks": bat.prefill_chunks - chunks0,
            "ttft_median_s": statistics.median(ttft),
            "ttft_max_s": max(ttft)}, launches, outs


def time_sync(fn, reps=5):
    """Median wall seconds of ``fn`` bracketed by device syncs."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def phase_tiered_full_width(seed):
    """Full-width minitron-4b, bf16, page 16, chunk 128, ``decode_flash``,
    8 slots, max_seq 1024, prefix cache on, a 1 GiB host tier: rounds A,
    B, A of the family traffic on a pool of the live pages at peak plus
    fewer pages than one family's cached blocks, so round B demotes A's
    blocks to T1 and round 3 promotes them; the same rounds with
    ``host_tier_bytes=0`` (round 3 recomputes) and A twice on a pool that
    keeps A on the card (device-resident hits).  Asserts demotions,
    rehits, no tier fault, B1 launched (decode + verify steps) x 32 in
    every round, and round 3 through T1 bit-identical to round 3 from
    device-resident hits; reports tokens/s, TTFTs, the tier counters, the
    staged engine's GB/s beside a pinned ``copy_`` of the same bytes, and
    the restore-vs-recompute crossover.  Returns {path: launches}."""
    from repro_torch.configs import get
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.kv_tiers import StagedTransferEngine
    from repro_torch.serve.serve_loop import make_chunk_prefill_step
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get("minitron-4b"), decode_flash=True,
                              kv_page_size=PAGE, prefill_chunk=CHUNK,
                              prefix_cache=True, kv_host_tier_bytes=T1_BYTES)
    params = registry.init(cfg, seed, device=DEVICE, dtype=torch.bfloat16)
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 43)
    fam = {"A": tier_family(cfg.vocab_size, rng),
           "B": tier_family(cfg.vocab_size, rng)}
    live = N_SLOTS * -(-(SYS_LEN + 128 + MAX_NEW) // PAGE)
    cached = sum(len(p) // PAGE for p in fam["A"]) - 3 * 4 * (SYS_LEN
                                                              // PAGE)
    check(TIER_POOL_SPARE < cached, "the pool would hold family A's blocks")
    pool = live + TIER_POOL_SPARE
    runs, paths, outs = {}, {}, {}
    for label, c, n_pages, rounds in (
            ("T1", cfg, pool, "ABA"),
            ("recompute", dataclasses.replace(cfg, kv_host_tier_bytes=0),
             pool, "ABA"),
            ("device hits", cfg, 2 * pool, "AA")):
        bat = ContinuousBatcher(c, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                                n_pages=n_pages, device=DEVICE)
        for i, f in enumerate(rounds):
            summary, launches, outs[label, i] = serve_round(bat, fam[f],
                                                            counts)
            paths[f"tiered serve [{label}] round {i + 1} ({f})"] = launches
            if bat._tiers is not None:
                t = bat.stats()["tiers"]
                summary["tiers"] = {k: t[k] for k in (
                    "demotions", "demote_skips", "rehits", "rehit_tokens",
                    "recomputes", "t1_entries", "t1_bytes", "t1_evictions",
                    "gathers", "scatters", "d2h_bytes", "h2d_bytes",
                    "gather_seconds", "scatter_seconds")}
            summary["prefix_hits"] = bat.prefix_hits
            summary["prefix_evictions"] = bat.prefix_evictions
            summary["preemptions"] = bat.preemptions
            runs[label, i] = summary
            print(f"tiered serve [{label}, round {i + 1}: family {f}, pool "
                  f"{n_pages} pages]: " + json.dumps(summary))
        ladder_quiet(bat, f"tiered serve, {label}")
        empty_index(bat)
        if label == "T1":
            t = bat.stats()["tiers"]
            check(t["demotions"] > 0 and t["rehits"] > 0,
                  f"no demotion or rehit at full width: {t}")
            x_bat = bat
        else:
            del bat
    same = [a == b for a, b in zip(outs["T1", 2], outs["device hits", 1])]
    check(all(same), f"round 3 through T1 differs from device-resident hits "
          f"in {same.count(False)} of {N_REQ} requests")

    def share(a, b):
        return (sum(x == y for x, y in zip(a, b)),
                float(np.mean([u == v for x, y in zip(a, b)
                               for u, v in zip(x, y)])))

    vs_cold = share(outs["T1", 2], outs["T1", 0])
    vs_rec = share(outs["T1", 2], outs["recompute", 2])
    print(f"tiered serve: round 3 through T1 == round 3 from device-resident "
          f"hits in {N_REQ} of {N_REQ} requests; vs round 1 (cold) "
          f"{vs_cold[0]} of {N_REQ} requests, {vs_cold[1]:.4f} of tokens; "
          f"vs round 3 recomputed {vs_rec[0]} of {N_REQ}, {vs_rec[1]:.4f} "
          "(reported, not held: other catch-up spans change GEMM shapes)")
    print("tiered serve TTFT s (median / worst): round 1 cold "
          f"{runs['T1', 0]['ttft_median_s']:.4f} / "
          f"{runs['T1', 0]['ttft_max_s']:.4f}; round 3 restore "
          f"{runs['T1', 2]['ttft_median_s']:.4f} / "
          f"{runs['T1', 2]['ttft_max_s']:.4f}; round 3 recompute "
          f"{runs['recompute', 2]['ttft_median_s']:.4f} / "
          f"{runs['recompute', 2]['ttft_max_s']:.4f}; round 3 device hits "
          f"{runs['device hits', 1]['ttft_median_s']:.4f} / "
          f"{runs['device hits', 1]['ttft_max_s']:.4f}")

    # the staged engine beside a pinned copy_ of the same bytes.
    bat = x_bat
    layout = bat.layout
    eng = StagedTransferEngine(layout)
    pages = list(range(128))                   # 128 pages = 256 MiB
    payload = eng.gather_host(bat.pools, {"kv": pages})  # warms the pool
    nbytes = sum(a.numel() * a.element_size() for a in payload["kv"].values())
    d2h = time_sync(lambda: eng.gather_host(bat.pools, {"kv": pages}))
    h2d = time_sync(lambda: eng.scatter_device(bat.pools, payload,
                                               {"kv": pages}))
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    plain_d2h = time_sync(lambda: host.copy_(dev, non_blocking=True))
    plain_h2d = time_sync(lambda: dev.copy_(host, non_blocking=True))
    rates = {"bytes": nbytes,
             "staged_d2h_GBps": nbytes / d2h / 1e9,
             "pinned_copy_d2h_GBps": nbytes / plain_d2h / 1e9,
             "staged_h2d_GBps": nbytes / h2d / 1e9,
             "pinned_copy_h2d_GBps": nbytes / plain_h2d / 1e9}
    print("staged engine vs a pinned copy_ of the same bytes (128 pages of "
          "K and V, 32 layers stacked in each leaf): " + json.dumps(rates))
    del dev, host, payload

    # restore (T1 promote of n tokens) against recompute (a chunk prefill
    # of the same n tokens), in the same call.
    tiers = bat._tiers
    cross = {}
    pos0 = torch.zeros(N_SLOTS, dtype=torch.int32, device=DEVICE)
    # slot 0's table: pages of its own, so the prefill writes its K/V.
    nb = bat.n_blocks["kv"]
    bt = {"kv": torch.full_like(bat.block_tab["kv"], bat.n_pages["kv"])}
    bt["kv"][0] = torch.arange(pool - nb, pool, dtype=torch.int32,
                               device=DEVICE)
    for n in CROSSOVER_N:
        pg = list(range(n // PAGE))
        blocks = [eng.gather_host(bat.pools, {"kv": [p]}) for p in pg]
        dst = list(range(200, 200 + len(pg)))
        promote = time_sync(lambda: tiers.restore_chain(
            bat.pools, blocks, {"kv": dst}))
        fn = make_chunk_prefill_step(cfg, n, MAX_SEQ, PAGE)
        seg = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(
            DEVICE)
        state = [pos0.clone(), pos0.clone(), pos0.clone(), pos0.bool()]

        def prefill():
            fn(params, bat.pools, bt, *state, seg,
               torch.zeros(1, dtype=torch.int32, device=DEVICE),
               torch.full((1,), n - 1, dtype=torch.int32, device=DEVICE),
               0, True, n, 2, 0)

        prefill()
        recompute = time_sync(prefill)
        cross[n] = {"promote_ms": promote * 1e3,
                    "prefill_ms": recompute * 1e3,
                    "restore_wins": promote < recompute}
    print("restore vs recompute (one T1 promote of n tokens vs one chunk "
          "prefill of the same n tokens, ms): " + json.dumps(cross)
          + f"; tier_restore_min_tokens default {cfg.tier_restore_min_tokens}")
    del bat, x_bat, params
    torch.cuda.empty_cache()
    print(f"tiered full-width phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# --- phase 5: the hlslib ops path at full size ----------------------------------------

STENCIL_GRID, STENCIL_SWEEPS = 16384, 64


def phase_hlslib_path(seed):
    """The package example's stages and the ``ops`` entry points with
    ``use_pallas=True``, at full size; counts set to 0 just before and
    read just after, outputs then held against the plain twins on the
    card.  Returns the path's launches."""
    from repro_torch.examples import dataflow_stencil as ex
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm_kernel import rmsnorm_plain
    from repro_torch.kernels.stencil import stencil2d, stencil2d_plain
    from repro_torch.kernels.treereduce_kernel import tree_row_reduce_plain
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)

    # stage 1: the eager ShiftReg stencil on the host, held to the kernel's
    # sweep of the same grid (the eager stage adds the taps in the paper's
    # order, north, west, east, south: fp32 rounding apart).
    xe = ex.make_grid(*ex.EAGER_SHAPE, seed)
    t = time.perf_counter()
    eager = ex.eager_stencil(xe)
    eager_s = time.perf_counter() - t
    swept_e = stencil2d(torch.from_numpy(xe).to(DEVICE)).cpu().numpy()
    err = float(np.abs(eager - swept_e).max())
    check(err <= 1e-6, f"eager ShiftReg stage vs the kernel: {err}")
    print(f"hlslib path: eager ShiftReg stencil {ex.EAGER_SHAPE} on the host "
          f"in {eager_s:.3f}s, max abs err vs the kernel's sweep {err}")

    G = STENCIL_GRID
    x = torch.randn((G, G), generator=gen, device=DEVICE)
    rows = torch.randn((32768, 4096), generator=gen, device=DEVICE)
    xn = torch.randn((4096, 3072), generator=gen, device=DEVICE).bfloat16()
    wn = (torch.randn(3072, generator=gen, device=DEVICE) * 0.1).bfloat16()
    q, k, v = make_attention(gen)
    counts = kernel_counts()
    torch.cuda.synchronize()
    reset_counts(counts)
    t0 = time.perf_counter()
    sweep, swept = ex.kernel_stages(x, STENCIL_SWEEPS)
    torch.cuda.synchronize()
    t_stencil = time.perf_counter() - t0
    red = {op: ops.row_reduce(rows, op=op, use_pallas=True)
           for op in ("add", "max")}
    normed = ops.fused_rmsnorm(xn, wn, use_pallas=True)
    att = ops.attention(q, k, v, use_pallas=True)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = read_counts(counts)
    want = {name: 0 for name in counts}
    want.update(stencil2d=1 + STENCIL_SWEEPS, tree_row_reduce=2, rmsnorm=1,
                flash_attention=1)
    check(launches == want, f"hlslib path launches {launches} != {want}")

    check(torch.equal(sweep, stencil2d_plain(x)),
          "ops.stencil sweep is not bit-equal to the plain twin")
    ref = x
    for _ in range(STENCIL_SWEEPS):
        ref = stencil2d_plain(ref)
    check(torch.isfinite(swept).all().item() and torch.equal(swept, ref),
          f"{STENCIL_SWEEPS} kernel sweeps are not bit-equal to the twin's")
    del x, sweep, swept, ref
    for op, got in red.items():
        check(torch.equal(got, tree_row_reduce_plain(rows, op)),
              f"ops.row_reduce {op} is not bit-equal to the plain twin")
    errs = {"rmsnorm": hold("B4", "ops path", normed, rmsnorm_plain(xn, wn),
                            "bf16"),
            "attention": hold("B5", "ops path", att,
                              flash_attention_plain(q, k, v), "bf16")}
    print("hlslib path [16384^2 fp32 stencil x 1 + "
          f"{STENCIL_SWEEPS} sweeps, row_reduce 32768 x 4096 add+max, "
          "fused_rmsnorm 4096 x 3072, attention 8 x 512]: " + json.dumps({
              "stencil_s": t_stencil,
              "stencil_ms_per_sweep_host": t_stencil / (1 + STENCIL_SWEEPS)
              * 1e3, "path_s": t_all, "launches": launches,
              "outputs_vs_plain": {"stencil": "bit-exact",
                                   "row_reduce": "bit-exact", **errs}}))
    del rows, xn, wn, q, k, v, red, normed, att
    torch.cuda.empty_cache()
    return launches


# --- telemetry and sampling ------------------------------------------------------------


def trace_counts(tel, bat, outs, label):
    """The JSONL trace alone gives back the batcher's counters: one token
    event per streamed token of each request, one first_token and one
    retire per request, the spec_verify events' sums, one prefill_chunk
    span per chunk and one decode_step / verify_round span per step,
    each equal to its histogram's count.  Returns the events by name."""
    evs = [json.loads(line) for line in tel.tracer.to_jsonl().splitlines()]
    names = {}
    for e in evs:
        names[e["name"]] = names.get(e["name"], 0) + 1
    for rid, out in enumerate(outs):
        n = sum(1 for e in evs if e["rid"] == rid and e["name"] == "token")
        check(n == len(out), f"[{label}] rid {rid}: {n} token events for "
              f"{len(out)} tokens")
    spec = [e["args"] for e in evs if e["name"] == "spec_verify"]
    check(sum(a["drafted"] for a in spec) == bat.spec_drafted
          and sum(a["accepted"] for a in spec) == bat.spec_accepted,
          f"[{label}] spec_verify events {spec} != counters "
          f"{bat.spec_drafted} / {bat.spec_accepted}")
    check(names.get("first_token", 0) == names.get("retire", 0)
          == tel.h_ttft.count == len(outs),
          f"[{label}] first_token / retire events {names}")
    check(names.get("prefill_chunk", 0) == tel.h_chunk.count
          == bat.prefill_chunks, f"[{label}] chunk spans {names}, "
          f"{bat.prefill_chunks} chunks")
    check(names.get("verify_round", 0) == tel.h_verify.count
          == bat.spec_verify_steps and names.get("decode_step", 0)
          == tel.h_step.count == bat.steps - bat.spec_verify_steps,
          f"[{label}] step spans {names}, {bat.steps} steps "
          f"({bat.spec_verify_steps} verify)")
    return names


def telemetry_smoke(seed):
    """Smoke width on the card (fp32 compute, weights drawn on the host
    from the seed): telemetry off and on (tracing and profiler ranges)
    give the same tokens on paged pools with the prefix cache and
    ``speculate_k`` 4 (bf16), on dense slots (bf16 and int8) and on int8
    pages that preempt, each with B1 / B3 launched steps x layers and
    B2's launches exact, and the trace gives back the counters; the
    ``cuda`` generator's samples are fixed by the seed, and a vanishing
    temperature samples the greedy tokens; reserve-at-admission admits 2
    slots where lazy growth admits 8 at an 8-page pool, with the same
    tokens."""
    from repro_torch.configs import get
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import params as PP
    from repro_torch.models import registry
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    from repro_torch.serve.serve_loop import greedy_generate
    from repro_torch.serve.telemetry import ServeTelemetry
    base = smoke_variant(get("minitron-4b"))
    params = PP.tree_map(lambda _, a: a.to(DEVICE),
                         registry.init(base, seed, device="cpu"))
    counts = kernel_counts()
    rng = np.random.default_rng(seed + 22)
    prompts = motif_prompts([9, 14, 6, 12], base.vocab_size, rng)
    prompts += prompts[:2]
    paged = dict(kv_page_size=8, prefill_chunk=8, decode_flash=True)
    cases = {
        "paged bf16, prefix cache + speculate_k 4": (dataclasses.replace(
            base, prefix_cache=True, speculate_k=4, speculate_ngram=1,
            **paged), {}),
        "dense bf16": (dataclasses.replace(base, decode_flash=True), {}),
        "dense int8": (dataclasses.replace(base, decode_flash=True,
                                           kv_cache_dtype="int8"), {}),
        "paged int8, 5-page pool": (dataclasses.replace(
            base, kv_cache_dtype="int8", **paged), {"n_pages": 5}),
    }
    for label, (cfg, kw) in cases.items():
        outs = {}
        for on in (False, True):
            tel = ServeTelemetry(profile=True) if on else None
            reset_counts(counts)
            outs[on], bat = run_batcher(cfg, params, prompts,
                                        [16] * len(prompts), n_slots=2,
                                        max_seq=48, telemetry=tel, **kw)
            n = read_counts(counts)
            attn = ("flash_attention_decode_paged" if bat.paged
                    else "flash_attention_decode")
            check(n[attn] == bat.steps * cfg.n_layers,
                  f"[{label}, telemetry {on}] {attn} launches {n[attn]} != "
                  f"steps {bat.steps} x layers")
            if cfg.kv_cache_dtype == "int8":
                want = b2_launches_expected(cfg, bat)
                check({k: n[k] for k in want} == want,
                      f"[{label}, telemetry {on}] B2 launches {n} != {want}")
            if bat.paged:
                empty_index(bat)
        check(outs[True] == outs[False], f"[{label}] telemetry on "
              f"{outs[True]} != off {outs[False]}")
        if "5-page" in label:
            check(bat.preemptions > 0, f"[{label}] no preemption")
        if "speculate" in label:
            check(bat.spec_verify_steps > 0 and bat.prefix_hits > 0,
                  f"[{label}] no verify step or prefix hit")
        names = trace_counts(tel, bat, outs[True], label)
        print(f"smoke telemetry [{label}]: on == off, {bat.steps} steps "
              f"({bat.spec_verify_steps} verify), {bat.preemptions} "
              f"preemptions, launches {json.dumps(n)}; trace events "
              + json.dumps(names))

    p = {"tokens": prompts[1][None]}
    draw = lambda t, s: greedy_generate(base, params, p, steps=12, max_seq=48,
                                        temperature=t, seed=s, device=DEVICE)
    greedy = draw(0.0, 0)
    a, b, c = draw(1.0, 3), draw(1.0, 3), draw(1.0, 4)
    check(np.array_equal(a, b) and not np.array_equal(a, c),
          f"cuda generator: seed 3 {a} / {b}, seed 4 {c}")
    check(((a >= 0) & (a < base.padded_vocab)).all(), "sample out of range")
    check(np.array_equal(draw(1e-6, 5), greedy), "T 1e-6 != greedy")
    print(f"smoke sampling [cuda generator]: seed 3 twice {a[0].tolist()}, "
          f"seed 4 {c[0].tolist()}; T 1e-6 == greedy {greedy[0].tolist()}")

    def fill(reserve):
        c = dataclasses.replace(base, kv_reserve_decode=reserve, **paged)
        bat = ContinuousBatcher(c, params, n_slots=8, max_seq=64,
                                n_pages=8, device=DEVICE)
        reqs = [Request(rid=i, prompt=prompts[0][:4], max_new=28)
                for i in range(8)]
        for r in reqs:
            bat.submit(r)
        progress = True
        while progress:
            progress = bat.admit() > 0
            while bat._admitting:
                bat._prefill_step()
                progress = True
        inflight = sum(r is not None for r in bat._slot_req)
        bat.run(len(reqs))
        outs = [drain(r) for r in reqs]
        check(bat.total_used_pages() == 0, "pages leaked")
        return inflight, outs, bat

    lazy, lazy_out, lazy_bat = fill(False)
    res, res_out, res_bat = fill(True)
    check((lazy, res) == (8, 2), f"admitted lazy {lazy}, reserve {res}")
    check(res_out == lazy_out, "reserve tokens != lazy tokens")
    check(res_bat.preemptions == 0, "reserve preempted")
    print(f"smoke reserve-at-admission [8 pages, 1-page prompts, 4-page "
          f"worst case]: admitted {res} slots (lazy {lazy}, "
          f"{lazy_bat.preemptions} preemptions); tokens equal")
    del params
    torch.cuda.empty_cache()


def bucket_of(v):
    """Index of the telemetry histogram bucket that holds ``v``."""
    import bisect
    from repro_torch.serve.telemetry import DEFAULT_TIME_BUCKETS
    return bisect.bisect_left(DEFAULT_TIME_BUCKETS, v)


def serve_with_telemetry(cfg, params, prompts, counts, telemetry):
    """The shared-prompt traffic through ``ContinuousBatcher`` under
    ``DataflowContext``, as ``serve_full_width`` serves it, with
    ``telemetry`` (or none).  With telemetry, a ``MetricsServer`` on a
    free port is scraped every 0.25 s while the batcher runs, each scrape
    validated, and once more after the run, where ``serve_steps_total``
    must equal the batcher's steps.  Each plain decode step is timed on
    the host (the step's call to its return, which follows the host read
    of its tokens).  Returns (summary, launches, batcher, outputs,
    decode step seconds)."""
    import threading
    import urllib.request
    from repro_torch.core.dataflow import DataflowContext
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    from repro_torch.serve.telemetry import MetricsServer, validate_exposition
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    bat = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                            telemetry=telemetry, device=DEVICE)
    step_s = []
    inner_step = bat.step

    def timed_step():
        steps, verify = bat.steps, bat.spec_verify_steps
        t0 = time.perf_counter()
        n = inner_step()
        if bat.steps > steps and bat.spec_verify_steps == verify:
            step_s.append(time.perf_counter() - t0)
        return n

    bat.step = timed_step
    server, scrapes, done = None, [], threading.Event()

    def scrape():
        with urllib.request.urlopen(server.url, timeout=10) as rsp:
            return validate_exposition(rsp.read().decode())

    def scraper():
        while not done.wait(0.25):
            scrapes.append(scrape()["serve_steps_total"])

    if telemetry is not None:
        server = MetricsServer(telemetry, port=0).start()
        watcher = threading.Thread(target=scraper, daemon=True)
        watcher.start()
    reset_counts(counts)
    t0 = time.perf_counter()
    try:
        with DataflowContext() as df:
            df.function(lambda: [bat.submit(r) for r in reqs],
                        name="producer")
            df.function(bat.run, len(reqs), name="batcher")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        final = None
        if server is not None:
            done.set()
            watcher.join(timeout=30)
            check(not watcher.is_alive(), "metrics scraper did not stop")
            final = scrape()
    finally:
        done.set()
        if server is not None:
            server.stop()
    outs = [drain(r) for r in reqs]
    check(all(len(o) == MAX_NEW for o in outs),
          f"token counts {[len(o) for o in outs]} != {MAX_NEW}")
    empty_index(bat)
    tokens = sum(len(o) for o in outs)
    summary = {"tokens_per_s": tokens / wall, "wall_s": wall,
               "steps": bat.steps, "verify_steps": bat.spec_verify_steps,
               "prefill_chunks": bat.prefill_chunks,
               "prefix_hits": bat.prefix_hits,
               "median_decode_step_ms": statistics.median(step_s) * 1e3}
    if final is not None:
        check(final["serve_steps_total"] == bat.steps,
              f"scraped serve_steps_total {final['serve_steps_total']} != "
              f"steps {bat.steps}")
        live = [s for s in scrapes if 0 < s < bat.steps]
        check(live, f"no scrape while the batcher ran: {scrapes}")
        summary["live_scrapes"] = len(live)
        summary["scraped_serve_steps_total"] = final["serve_steps_total"]
    return summary, launches, bat, outs, step_s


def profile_serve_window(cfg, params, prompts, counts):
    """The same traffic with ``profile=True``, in this thread, a
    ``torch.profiler`` window opened at the 16th decode or verify step
    and closed at the first step or chunk after it holds at least 12
    decode steps, a verify step and a chunk (or 64 calls): each kind of
    ``serve.*`` range counts the calls of its kind in the window, B1's
    wrapper counts a launch a layer inside each ``serve.decode_step`` and
    ``serve.verify`` range and none inside a ``serve.prefill_chunk``
    range (counted as each range opens and closes), and the profile holds
    that many B1 kernels.

    Device ms per range: a kernel counts with the range whose start is
    the last before the kernel's start on the card (every step and chunk
    ends in a host read of its tokens; kernels launched between ranges,
    the block-table updates, count with the range before them).  The
    profiler links kernels launched through the C interface to no host
    event, and its device clock drifts from the host's by up to a few
    kernels over a long process, so these sums are a split, not a count.
    Returns the window's counts and each kind's device ms per range."""
    import bisect
    import contextlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.batching import ContinuousBatcher, Request, drain
    from repro_torch.serve.telemetry import ServeTelemetry
    tel = ServeTelemetry(trace=False, profile=True)
    bat = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                            queue_depth=N_REQ, telemetry=tel, device=DEVICE)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        bat.submit(r)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    win = {"open": False, "done": False, "calls": 0}
    b1 = counts["flash_attention_decode_paged"]
    inside = dict.fromkeys(("serve.decode_step", "serve.verify",
                            "serve.prefill_chunk"), 0)
    annotate = tel.annotate

    @contextlib.contextmanager
    def counted(name, step=None):
        before = b1.launches
        with annotate(name, step):
            yield
        if win["open"] and not win["done"]:
            inside[name] += b1.launches - before

    tel.annotate = counted

    def taken():
        return {"serve.decode_step": bat.steps - bat.spec_verify_steps,
                "serve.verify": bat.spec_verify_steps,
                "serve.prefill_chunk": bat.prefill_chunks}

    def gate():
        if win["done"]:
            return
        if not win["open"] and bat.steps >= 16:
            torch.cuda.synchronize()
            reset_counts(counts)
            win.update(open=True, at=taken())
            prof.start()
        elif win["open"]:
            win["calls"] += 1
            got = {k: v - win["at"][k] for k, v in taken().items()}
            if win["calls"] >= 64 or (got["serve.decode_step"] >= 12
                                      and got["serve.verify"] >= 1
                                      and got["serve.prefill_chunk"] >= 1):
                torch.cuda.synchronize()
                prof.stop()
                win.update(done=True, taken=got, launches=read_counts(counts))

    for name in ("step", "_prefill_step"):
        inner = getattr(bat, name)

        def gated(inner=inner):
            gate()
            return inner()

        setattr(bat, name, gated)
    bat.run(len(reqs))
    [drain(r) for r in reqs]
    check(win["done"], f"the profiler window never closed: {win}")
    got = win["taken"]
    n_b1 = win["launches"]["flash_attention_decode_paged"]
    want_b1 = (got["serve.decode_step"] + got["serve.verify"]) * cfg.n_layers
    check(n_b1 == want_b1, f"B1 launches in the window {n_b1} != {want_b1}")
    spans = {k: [] for k in got}
    for ev in prof.events():
        kind = ev.name.split("#")[0]
        if kind in spans and ev.device_type == DeviceType.CPU:
            spans[kind].append(ev)
    counted = {k: len(v) for k, v in spans.items()}
    check(counted == got, f"ranges {counted} != calls in the window {got}")
    opened = sorted((ev.time_range.start, kind)
                    for kind, evs in spans.items() for ev in evs)
    starts = [t for t, _ in opened]
    busy_us = dict.fromkeys(spans, 0.0)
    b1_in = dict.fromkeys(spans, 0)
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA
                or ev.name.startswith(("serve.", "Memcpy", "Memset"))):
            continue
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        if i < 0:
            continue
        kind = opened[i][1]
        busy_us[kind] += ev.time_range.elapsed_us()
        b1_in[kind] += "flash_decode_paged_kernel" in ev.name
    device_ms = {k: busy_us[k] / 1e3 / counted[k] if counted[k] else None
                 for k in spans}
    want = {k: (v * cfg.n_layers if k != "serve.prefill_chunk" else 0)
            for k, v in got.items()}
    check(inside == want, f"B1 launches inside the ranges {inside} != "
          f"{want}")
    check(sum(b1_in.values()) == n_b1, f"B1 kernels in the profile "
          f"{sum(b1_in.values())} != launches {n_b1}")
    empty_index(bat)
    return {"window_calls": got, "ranges": counted,
            "b1_launches": n_b1, "b1_launches_inside_ranges": inside,
            "b1_kernels_in_profile": sum(b1_in.values()),
            "device_ms_per_range": device_ms}


# Depth cut to TEL_LAYERS of 32 (widths and vocab whole) to keep the
# script inside its time limit beside the sharded-training phase.
TEL_LAYERS = 16


def telemetry_full_width(seed):
    """Full-width minitron-4b at ``TEL_LAYERS`` layers, bf16, paged through
    B1 (page 16, chunk 128, 8 slots, max_seq 1024) with the prefix cache,
    ``prefill_exact`` and ``speculate_k`` 4 on the shared-prompt traffic:
    served with telemetry off, then on (on: tracing, profiler ranges and
    a live ``/metrics`` scrape), B1 launched (decode + verify steps) x
    layers in
    each, the trace giving back the counters, the decode-step
    histogram's p50 in the bucket of the host-timed median decode step;
    then a profiler window over the same serve.  Returns {path:
    launches}."""
    from repro_torch.configs import get
    from repro_torch.models import registry
    from repro_torch.serve.telemetry import ServeTelemetry
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        get("minitron-4b"), n_layers=TEL_LAYERS, decode_flash=True,
        kv_page_size=PAGE, prefill_chunk=CHUNK, prefix_cache=True,
        prefill_exact=True, speculate_k=SPEC_K, speculate_ngram=1)
    params = registry.init(cfg, seed, device=DEVICE, dtype=torch.bfloat16)
    print(f"full width: minitron-4b, {cfg.n_layers} of 32 layers "
          "(widths and vocab whole)")
    counts = kernel_counts()
    prompts = shared_prompt_traffic(cfg.vocab_size,
                                    np.random.default_rng(seed + 19))
    paths, runs, outs = {}, [], []
    for i, on in enumerate((False, True)):
        tel = ServeTelemetry(profile=True) if on else None
        summary, launches, bat, out, step_s = serve_with_telemetry(
            cfg, params, prompts, counts, tel)
        check(launches["flash_attention_decode_paged"]
              == bat.steps * cfg.n_layers,
              f"[telemetry {on}] B1 launches {launches} != steps "
              f"{bat.steps} x {cfg.n_layers}")
        check(bat.spec_verify_steps > 0 and bat.prefix_hits > 0,
              f"[telemetry {on}] no verify step or prefix hit")
        if on:
            summary["trace_events"] = trace_counts(tel, bat, out,
                                                   "full width")
            p50 = tel.h_step.quantile(0.5)
            med = statistics.median(step_s)
            summary["decode_step_p50_ms"] = p50 * 1e3
            summary["decode_step_histogram"] = tel.h_step.summary()
            check(bucket_of(p50) == bucket_of(med),
                  f"decode-step p50 {p50} s and the host-timed median "
                  f"{med} s fall in different buckets")
        summary["telemetry"] = on
        runs.append(summary)
        outs.append(out)
        paths[f"paged bf16 shared prompt, speculate_k 4, telemetry run "
              f"{i + 1}"] = launches
        print(f"full-width telemetry [run {i + 1}, telemetry "
              f"{'on' if on else 'off'}]: " + json.dumps(summary))
        del bat
    same = [sum(x == y for x, y in zip(outs[0], o)) for o in outs[1:]]
    on_tps = [r["tokens_per_s"] for r in runs if r["telemetry"]]
    off_tps = [r["tokens_per_s"] for r in runs if not r["telemetry"]]
    print(f"full-width telemetry cost: tokens/s on {on_tps}, off {off_tps}; "
          f"mean on / off {statistics.mean(on_tps) / statistics.mean(off_tps):.4f}"
          f" (reported, not claimed); requests token-identical to run 1: "
          f"{same} of {N_REQ}")
    window = profile_serve_window(cfg, params, prompts, counts)
    print("full-width profiler window [telemetry profile=True]: "
          + json.dumps(window))
    print(f"full-width telemetry phase: {time.perf_counter() - t_phase:.1f}s")
    del params
    torch.cuda.empty_cache()
    return paths


def phase_telemetry_sampling(seed):
    """Telemetry (A10c) and sampling with reserve-at-admission (A11):
    ``telemetry_smoke`` at smoke width, then ``telemetry_full_width``.
    Returns {path: launches} of the full-width serves."""
    t = time.perf_counter()
    telemetry_smoke(seed)
    print(f"smoke telemetry and sampling: {time.perf_counter() - t:.1f}s")
    return telemetry_full_width(seed)


# --- the roofline (A16 at one device) ------------------------------------------------

ROOFLINE_BUDGET_S = 120


def count_cell(task):
    """Count one step on fake CPU tensors in a worker process: a dry-run
    cell (``dryrun.run_cell``), or with ``cfg`` given a full-width step as
    the card ran it (bf16 parameters, one microbatch).  Returns (task,
    roofline record or None, error or None, seconds)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from repro_torch.configs import SHAPES, ShapeCfg, get
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.roofline import analysis as RA
    from repro_torch.train import train_loop as TL
    t = time.perf_counter()
    try:
        if "cfg" in task:
            cfg = task["cfg"]
            shape = ShapeCfg(task["label"], *task["shape"])
            costs, _ = dryrun.lower_cell(
                cfg, shape, tcfg=TL.TrainCfg(), param_dtype=torch.bfloat16,
                scopes=False)
            rec = RA.analyze(costs, cfg, shape, dryrun.MESH_NAME,
                             dryrun.N_CHIPS, registry.num_active_params(cfg)
                             ).to_dict(dryrun.N_CHIPS)
        else:
            rec = dryrun.run_cell(get(task["arch"]), SHAPES[task["shape"]],
                                  verbose=False, scopes=False)
        return task, rec, None, time.perf_counter() - t
    except Exception as e:                       # reported, then failed
        return task, None, repr(e), time.perf_counter() - t


def phase_roofline(card_line, measured):
    """Every dry-run cell's roofline at one H100, then the bound of each
    full-width step this run timed (``measured``) beside its measured ms.
    The cells and the train step are counted on fake CPU tensors in
    worker processes (spawned: the parent holds the card); the other
    steps were counted on the card by ``count_step``."""
    import concurrent.futures
    import multiprocessing
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.roofline import analysis as RA
    t_phase = time.perf_counter()
    print(f"roofline phase: budget {ROOFLINE_BUDGET_S} s (the whole script "
          "within 1200 s)")
    cells = [{"arch": cfg.name, "shape": shape.name}
             for cfg, shape in dryrun.cells()]
    # the longest (train) cells first, so the workers finish together.
    cells.sort(key=lambda c: not c["shape"].startswith("train"))
    tasks = [{"label": label, "cfg": m["cfg"], "shape": m["shape"]}
             for label, m in measured.items() if m["shape"][0] == "train"]
    workers = min(8, os.cpu_count() or 1)
    done = {}
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for task, rec, err, sec in ex.map(count_cell, tasks + cells):
            key = task.get("label") or (task["arch"], task["shape"])
            done[key] = (rec, err, sec)
    failed = []
    for c in cells:
        rec, err, sec = done[(c["arch"], c["shape"])]
        tag = f"{c['arch']} × {c['shape']} × {dryrun.MESH_NAME}"
        if err:
            failed.append(tag)
            print(f"roofline FAIL {tag}: {err}")
            continue
        print(f"roofline PASS {tag}: bound {rec['t_bound_s'] * 1e3:.6g} ms "
              f"({rec['bottleneck']}; compute {rec['t_compute_s'] * 1e3:.6g}"
              f" ms, memory {rec['t_memory_s'] * 1e3:.6g} ms), mfu_bound "
              f"{rec['mfu_bound']:.4f}, counted in {sec:.1f}s")
    check(not failed, f"roofline: {len(failed)} cells failed: {failed}")
    for label, m in measured.items():
        if label in done:
            rec, err, _ = done[label]
            check(err is None, f"roofline [{label}]: {err}")
        else:
            shape = ShapeCfg(label, *m["shape"])
            rec = RA.analyze(m["costs"], m["cfg"], shape, dryrun.MESH_NAME,
                             dryrun.N_CHIPS,
                             registry.num_active_params(m["cfg"])
                             ).to_dict(dryrun.N_CHIPS)
        bound_ms = rec["t_bound_s"] * 1e3
        check(bound_ms > 0 and m["ms"] > 0, f"roofline [{label}]: {rec}")
        print(f"roofline step [{label}]: measured {m['ms']:.6g} ms wall "
              f"(device busy {m['device_busy_ms']} ms), bound "
              f"{bound_ms:.6g} ms ({rec['bottleneck']}: "
              f"{rec['flops_per_device']:.6g} FLOPs, "
              f"{rec['bytes_per_device']:.6g} bytes), share of the bound "
              f"{bound_ms / m['ms']:.4f}, model FLOPs "
              f"{rec['model_flops_global']:.6g}; {card_line}")
    print(f"roofline phase: {time.perf_counter() - t_phase:.1f}s "
          f"({len(cells)} cells, {workers} workers)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = torch.cuda.get_device_name(0)
    card_line = f"card: {smi.stdout.strip().splitlines()[0]}"
    print(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    reports = build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.2f}s "
          f"({', '.join(sorted(reports)) or 'up to date'})")
    for name, rep in sorted(reports.items()):
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", rep)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                rep))
        print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes of spill stores")
        if name in ("flash_attention", "flash_decode_paged"):
            for fn, n_regs, n_spill in ptxas_entries(rep):
                print(f"    {fn}: {n_regs} registers, {n_spill} bytes of "
                      "spill stores")
    hmma = tensor_core_ops(build._lib_path(build.sources()["flash_attention"]))
    print("B5 tensor-core instructions (cuobjdump -sass, HMMA/HGMMA): "
          + json.dumps(hmma))
    check(all(n > 0 for fn, n in hmma.items() if "flash_fwd_tc_kernel" in fn)
          and any("flash_fwd_tc_kernel" in fn for fn in hmma),
          f"B5's bf16 kernels run no tensor-core instruction: {hmma}")

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    b1 = phase_kernel(gen, card, flush)["main (8 seqs, pos <= 1k, bf16)"]
    b3 = phase_dense_kernel(gen, card, flush)[
        "main (8 slots x 1024, pos 128-1023, bf16)"]
    b2 = phase_quant_kernel(gen, card, flush)
    b2s = phase_store_kernel(gen, card, flush)
    hl = phase_hlslib_kernels(gen, card, flush)
    b6 = phase_ssd_kernel(gen, card, flush)
    del flush
    phase_host_runtime()
    phase_exactness(args.seed)
    phase_prefix_spec_exactness(args.seed)
    phase_recurrent_exactness(args.seed)
    phase_gemma3_exactness(args.seed)
    phase_tier_resilience_exactness(args.seed)
    phase_moe_exactness(args.seed)
    phase_vlm_audio_exactness(args.seed)
    phase_train_exactness(args.seed)
    measured = {}
    paths = phase_full_width(args.seed, measured)
    spec_paths = phase_prefix_spec_full_width(args.seed)
    tier_paths = phase_tiered_full_width(args.seed)
    paths["hlslib ops"] = phase_hlslib_path(args.seed)
    paths.update(phase_recurrent_full_width(args.seed))
    g3_paths = phase_gemma3_full_width(args.seed)
    moe_paths = phase_moe_full_width(args.seed)
    va_paths = phase_vlm_audio_full_width(args.seed)
    tel_paths = phase_telemetry_sampling(args.seed)
    unsharded = phase_train_full_width(args.seed, measured)
    phase_roofline(card_line, measured)
    phase_sharded_train(args.seed, unsharded, card_line)

    # each kernel's row: its launches on the full-width path that runs it,
    # its numbers at that path's shapes (B2: the store at the decode rows
    # of each step, quantize at the whole slot cache a prefill converts,
    # dequantize at the full slot cache each step reads back).
    d_rows = b2["full cache (8*8*1024 x 128, bf16)"]
    # B1's launches: every paged bf16 serve, decode and verify steps
    # (minitron-4b's, its tiered rounds', its telemetry runs' and
    # gemma3-12b's and phi3.5-moe's); B3's: the dense bf16 serves and
    # the vlm / audio generations.
    b1_paths = ([paths["paged bf16"]] + list(spec_paths.values())
                + list(tier_paths.values()) + list(tel_paths.values())
                + [g3_paths["gemma3-12b paged"],
                   g3_paths["gemma3-12b paged, speculate_k 4"]])
    b3_paths = [paths["dense bfloat16"], g3_paths["gemma3-12b dense"],
                moe_paths["phi3p5-moe-42b dense"]] + list(va_paths.values())
    b1_paths.append(moe_paths["phi3p5-moe-42b paged"])
    b1_paths.append(g3_paths["gemma3-12b paged, speculate_k 4, 2 scratch "
                             "pages per slot"])
    rows = {
        "flash_attention_decode_paged": ({
            "flash_attention_decode_paged": sum(
                p["flash_attention_decode_paged"] for p in b1_paths)}, b1),
        "flash_attention_decode": ({
            "flash_attention_decode": sum(
                p["flash_attention_decode"] for p in b3_paths)}, b3),
        "kv_quantize_store": (paths["dense int8"], b2s[
            "dense decode rows (8 slots x 8 kv heads, K and V, d 128, "
            "bf16)"]),
        "kv_quantize": (paths["dense int8"], {
            "max_abs_err": d_rows["max_abs_err"], "ms": d_rows["quantize_ms"],
            "plain_ms": d_rows["quantize_plain_ms"],
            "bound_ms": d_rows["quantize_bound_ms"], "bound_by": "bytes",
            "library_ms": None}),
        "kv_dequantize": (paths["dense int8"], {
            "max_abs_err": d_rows["max_abs_err"],
            "ms": d_rows["dequantize_ms"],
            "plain_ms": d_rows["dequantize_plain_ms"],
            "bound_ms": d_rows["dequantize_bound_ms"], "bound_by": "bytes",
            "library_ms": d_rows["dequantize_library_ms"]}),
    }
    # the hlslib kernels: launches on the ops path, numbers at its shapes.
    for name, case in (
            ("stencil2d", "main (16384 x 16384 fp32)"),
            ("tree_row_reduce", "main add (32768 x 4096 fp32)"),
            ("rmsnorm", "main (4096 x 3072 bf16, 8 prompts x 512 tokens)"),
            ("flash_attention",
             "main (8 x 512, hq 24 / hkv 8, d 128, bf16, causal)")):
        rows[name] = (paths["hlslib ops"], hl[name][case])
    # B6: launches on mamba2's train forward, numbers at its layer's shape.
    rows["ssd_scan"] = (paths["mamba2-1p3b train"], b6[
        "main (one mamba2 layer: b 4 x s 2048, h 64, dh 64, ds 128, "
        "chunk 256)"])
    kernels = []
    for name, (launches, m) in rows.items():
        check(launches[name] > 0, f"{name} never launched on its path")
        src, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all, the "
          "kernels' build included")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
