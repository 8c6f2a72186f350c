"""Optimized-configuration sweep (port of ``launch/sweep_optimized.py``):
every (arch × shape) cell with the §Perf levers that transferred, counted
at one H100 by the dry-run:

* train/prefill: causal block skipping (+ grouped MoE dispatch for MoE)
* decode: int8 KV cache (+ block skipping for prefill math)

The reference also shards decode's KV over the sequence
(``decode_seq_shard``); on one device there is no mesh axis to shard
over, so that lever is left out here (it comes with the production
meshes, A13c in ROADMAP.md).

Writes results_dryrun_optimized.json (or the path given) with the same
schema as the dry-run, so the before/after table is a straight join::

    PYTHONPATH=src python -m repro_torch.launch.sweep_optimized [out.json]
"""

import json
import sys
import traceback

from .dryrun import cells, run_cell


def extras_for(cfg, shape):
    e = {}
    if cfg.n_heads:                       # any attention in the stack
        e["attn_block_skip"] = True
    if cfg.n_experts:
        e["moe_groups"] = 32
    if shape.kind == "decode":
        # no decode_seq_shard: one device has no axis to shard over.
        e["kv_cache_dtype"] = "int8"
    return e


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "results_dryrun_optimized.json"
    results, failures = [], []
    for cfg, shape in cells():
        extra = extras_for(cfg, shape)
        tag = f"{cfg.name} × {shape.name}"
        try:
            rec = run_cell(cfg, shape, False, extra, verbose=False)
            rec["extras"] = extra
            results.append(rec)
            print(f"PASS {tag} bottleneck={rec['bottleneck']} "
                  f"mfu={rec['mfu_bound']:.4f}", flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e}", flush=True)
            traceback.print_exc()
    with open(out, "w") as f:
        json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"{len(results)} passed, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
