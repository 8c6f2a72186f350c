"""Batched serving entry point: continuous batching over Streams.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
        --smoke --device cpu --decode-flash --kv-cache-dtype int8 \
        --requests 8 --slots 4 --prompt-len 8 --max-new 16

Serves dense slots by default; ``--page-size N`` serves paged KV with
chunked prefill instead.  Runs on ``--device cuda`` by default.  Weights
are random, drawn from ``--seed`` on the device.  ``--decode-flash`` and
``--kv-cache-dtype`` set the config's fields of the same names: decode
attention through ``kernels.flash_attention`` (``flash_attention_decode``
on dense slots, ``flash_attention_decode_paged`` on pages), and an int8
KV cache quantized through ``kernels.kv_quant``.  The recurrent
families (``--arch mamba2-1p3b``, ``zamba2-1p2b``) keep O(1) state per
slot and have no pageable layout: they serve dense slots with prompts
admitted at their exact length, and ``--page-size`` falls back to dense
slots, as the reference's CLI does; ``--decode-flash`` reaches zamba2's
shared attention block.  gemma3 (``--arch gemma3-12b``) serves paged and
dense: its sliding-window layers read a ring of pages (paged) or a
rolled window cache (dense), its global layers the flat table or the
full cache; its ring group cannot be shared, so ``--prefix-cache`` serves
with the prefix cache off, as the reference does:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --smoke --device cpu --page-size 8 --prompt-len 24 --max-seq 48

Paged serving also takes the prefix cache (``--prefix-cache``, with
``--shared-prefix N`` giving every request the same first N tokens, and
``--prefill-exact``) and speculative decode (``--speculate-k K`` or
``--speculate``); the summary then prints their counters:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
        --smoke --device cpu --page-size 8 --prompt-len 24 --max-seq 64 \
        --prefix-cache --shared-prefix 16 --speculate

Tiered KV memory and resilient serving: ``--host-tier-bytes`` (needs
``--prefix-cache``) puts a host-RAM tier behind the page pool,
``--tier-snapshot`` (needs ``--host-tier-bytes``) loads and saves its
on-disk snapshot, ``--tier-restore-min`` sets the recompute-vs-restore
crossover; ``--schedule``, ``--overload``, ``--queue-depth``,
``--deadline-ms`` and ``--klass`` set the SLA lifecycle, ``--faults``
injects deterministic faults and ``--supervise`` serves under the
``ServeSupervisor``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
        --smoke --device cpu --page-size 8 --pages 12 --prompt-len 24 \
        --max-seq 64 --prefix-cache --shared-prefix 16 \
        --host-tier-bytes 1048576 --faults step:3 --supervise
"""

import argparse
import dataclasses
import time

import numpy as np

from ..configs import get as get_arch
from ..configs.base import smoke_variant
from ..core.dataflow import DataflowContext
from ..models import registry
from ..models.transformer import torch_dtype
from ..serve.batching import ContinuousBatcher, Request, RequestFailed, drain
from ..serve.resilience import ServeSupervisor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size; > 0 enables the paged batcher "
                         "(page pools + chunked prefill), 0 serves dense "
                         "slots")
    ap.add_argument("--pages", type=int, default=0,
                    help="page pool size (default: dense-equivalent)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for weights, pools and slot state")
    ap.add_argument("--decode-flash", action="store_true",
                    help="decode attention through the CUDA kernels (their "
                         "plain twins on the CPU)")
    ap.add_argument("--kv-cache-dtype", choices=("bfloat16", "int8"),
                    default="bfloat16",
                    help="KV cache storage: bf16, or int8 with per-row bf16 "
                         "scales")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical prompt prefixes via the "
                         "refcounted page pool (paged mode only)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N prompt tokens identical across all "
                         "requests (system-prompt workload; demos "
                         "--prefix-cache hits)")
    ap.add_argument("--prefill-exact", action="store_true",
                    help="recompute prompt K/V at the final chunk so "
                         "chunked prefill is bit-exact vs dense")
    ap.add_argument("--host-tier-bytes", type=int, default=0,
                    help="host-RAM tier (T1) byte budget: evicted "
                         "prefixes demote there and rehits restore "
                         "instead of recomputing (needs --prefix-cache)")
    ap.add_argument("--tier-snapshot", default="",
                    help="on-disk snapshot (T2) path: loaded at start "
                         "if present, saved at exit — cached prompts "
                         "survive restarts (needs --host-tier-bytes)")
    ap.add_argument("--tier-restore-min", type=int, default=-1,
                    help="recompute-vs-restore crossover in tokens "
                         "(default: cfg.tier_restore_min_tokens)")
    ap.add_argument("--schedule", choices=("fifo", "sla"), default=None,
                    help="admission order: arrival (fifo) or SLA class "
                         "rank + deadline (sla)")
    ap.add_argument("--overload", choices=("block", "reject"), default=None,
                    help="full-queue policy: backpressure the producer "
                         "(block) or shed with a typed rejection (reject)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="request queue depth (0 = 2*slots)")
    ap.add_argument("--faults", default="",
                    help="deterministic fault-injection spec, e.g. "
                         "'step:3;t1_d2h:1+' (see serve.resilience)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under ServeSupervisor: watchdog heartbeat "
                         "+ journaled crash recovery on fatal step "
                         "faults (paged mode)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="speculative decode: n-gram drafter proposes up "
                         "to K tokens/slot, one batched verify call "
                         "scores them (paged mode only; output stays "
                         "bit-identical to plain greedy decode)")
    ap.add_argument("--speculate", action="store_true",
                    help="shorthand for --speculate-k 4")
    ap.add_argument("--speculate-probe", type=int, default=-1,
                    help="re-probe period for self-disabled drafter "
                         "slots in steps (0 = sticky disable; default: "
                         "config value)")
    ap.add_argument("--deadline-ms", type=float, default=0,
                    help="per-request deadline in ms (0 = none); "
                         "expired requests are cancelled, pages freed")
    ap.add_argument("--klass", choices=("latency", "standard", "batch"),
                    default="standard",
                    help="SLA class stamped on every generated request")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.tier_snapshot and not args.host_tier_bytes:
        ap.error("--tier-snapshot needs the host tier: pass "
                 "--host-tier-bytes as well")
    if args.host_tier_bytes and not args.prefix_cache:
        ap.error("--host-tier-bytes needs --prefix-cache (demotion is "
                 "keyed by the prefix index)")
    page = args.page_size or cfg.kv_page_size
    speculate_k = args.speculate_k or (4 if args.speculate else 0)
    if args.prefix_cache and not page:
        ap.error("--prefix-cache needs the paged batcher: pass "
                 "--page-size as well")
    if speculate_k and not page:
        ap.error("--speculate/--speculate-k needs the paged batcher "
                 "(rollback swaps block tables): pass --page-size")
    kw = dict(kv_page_size=page, decode_flash=args.decode_flash,
              kv_cache_dtype=args.kv_cache_dtype,
              prefix_cache=args.prefix_cache,
              prefill_exact=args.prefill_exact, speculate_k=speculate_k,
              kv_host_tier_bytes=args.host_tier_bytes,
              kv_tier_snapshot=args.tier_snapshot)
    if args.speculate_probe >= 0:
        kw["speculate_probe"] = args.speculate_probe
    if args.tier_restore_min >= 0:
        kw["tier_restore_min_tokens"] = args.tier_restore_min
    cfg = dataclasses.replace(cfg, **kw)
    # bf16 weights are drawn in bf16 directly; forward casts to cfg.dtype.
    params = registry.init(cfg, args.seed, device=args.device,
                           dtype=torch_dtype(cfg.dtype))
    rng = np.random.default_rng(args.seed)
    batcher = ContinuousBatcher(cfg, params, n_slots=args.slots,
                                max_seq=args.max_seq,
                                n_pages=args.pages or None,
                                schedule=args.schedule,
                                overload=args.overload,
                                queue_depth=args.queue_depth or None,
                                faults=args.faults or None,
                                device=args.device)
    supervisor = ServeSupervisor(batcher) if args.supervise else None
    sysp = rng.integers(0, cfg.vocab_size,
                        min(args.shared_prefix,
                            args.prompt_len)).astype(np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate([sysp, rng.integers(
                0, cfg.vocab_size,
                args.prompt_len - len(sysp)).astype(np.int32)]),
                    max_new=args.max_new, klass=args.klass,
                    deadline_ms=args.deadline_ms or None)
            for i in range(args.requests)]

    t0 = time.time()
    # The paper's Read/Compute/Write dataflow: producer PE feeds the
    # request stream, the batcher PE decodes, consumers drain outputs.
    with DataflowContext() as df:
        def producer():
            # a rejected request's failure is already in its stream;
            # closing the request stream lets the batcher end once the
            # accepted ones are served.
            for r in reqs:
                try:
                    batcher.submit(r)
                except ValueError:
                    pass
            batcher.requests.close()
        df.function(producer, name="producer")
        run = supervisor.run if supervisor is not None else batcher.run
        df.function(run, len(reqs), name="batcher")
    dt = time.time() - t0

    total_tokens = 0
    failed = 0
    for r in reqs:
        try:
            out = drain(r)
        except RequestFailed as e:
            failed += 1
            print(f"req {r.rid}: {type(e).__name__}: {e.reason} "
                  f"({len(e.tokens)} token(s) streamed)")
            continue
        total_tokens += len(out)
        print(f"req {r.rid}: {out[:12]}{'...' if len(out) > 12 else ''}")
    if batcher.paged:
        st = batcher.stats()
        pool = ",".join(f"{k}:{v}"
                        for k, v in sorted(batcher.n_pages.items()))
        mode = (f"paged(page={batcher.page_size},pool={pool},"
                f"chunks={batcher.prefill_chunks},"
                f"preempt={batcher.preemptions})")
        if batcher.prefix_cache:
            print(f"prefix-cache: hit-rate {st['prefix_hit_rate']:.2f} "
                  f"({st['prefix_hits']}/{st['prefix_lookups']} lookups, "
                  f"{st['prefix_hit_tokens']} tokens skipped), "
                  f"shared pages {st['shared_pages']}, "
                  f"cow copies {st['cow_copies']}, "
                  f"evicted prefixes {st['prefix_evictions']}, "
                  f"cached {st['cached_prefixes']} prefixes / "
                  f"{st['cached_prefix_pages']} pages, "
                  f"pools {st['pools']}")
        else:
            print(f"pages: shared {st['shared_pages']}, "
                  f"cow copies {st['cow_copies']}, pools {st['pools']}")
        sp = st["speculation"]
        if sp["k"]:
            print(f"speculation: k={sp['k']}, drafted {sp['drafted']}, "
                  f"accepted {sp['accepted']} "
                  f"(rate {sp['acceptance_rate']:.2f}), "
                  f"rolled back {sp['rolled_back']}, "
                  f"verify steps {sp['verify_steps']}, "
                  f"decode steps saved {sp['decode_steps_saved']}")
        if "tiers" in st:
            t = st["tiers"]
            print(f"kv tiers: T1 {t['t1_entries']} entries / "
                  f"{t['t1_bytes']}B of {t['t1_budget_bytes']}B "
                  f"({t['t1_evictions']} evicted), "
                  f"demotions {t['demotions']} "
                  f"(+{t['demote_skips']} cached), "
                  f"rehits {t['rehits']} ({t['rehit_tokens']} tokens "
                  f"restored), recomputes {t['recomputes']}, "
                  f"recompute-resumes {t['recompute_resumes']}, "
                  f"transfers {t['staged_gathers']}G/"
                  f"{t['staged_scatters']}S "
                  f"({t['d2h_bytes']}B down, {t['h2d_bytes']}B up)")
        if batcher._tiers is not None and batcher.tier_snapshot:
            n = batcher.save_tier_snapshot()
            print(f"kv tiers: snapshot saved to {n}")
    else:
        mode = "dense"
    st = batcher.stats()
    if (failed or st["rejections"] or st["expired"] or st["errored"]
            or st["cancelled"] or st.get("restarts")
            or st.get("tier_disabled") or args.supervise):
        rej = ",".join(f"{k}:{v}" for k, v in sorted(
            st["rejections"].items())) or "none"
        extra = ""
        if supervisor is not None:
            rep = supervisor.report
            extra = (f", supervisor restarts {rep.restarts} "
                     f"(recovered {rep.recovered_requests} requests, "
                     f"{rep.stalls} stalls)")
        print(f"resilience: rejections [{rej}], expired {st['expired']}, "
              f"errored {st['errored']}, cancelled {st['cancelled']}, "
              f"tier faults {st.get('tier_faults', 0)}"
              f"{' (tier DISABLED)' if st.get('tier_disabled') else ''}"
              f"{extra}")
    print(f"{len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s, {batcher.steps} decode steps, "
          f"{mode}, "
          f"slot-util {total_tokens/max(batcher.steps,1)/args.slots:.2f})")


if __name__ == "__main__":
    main()
