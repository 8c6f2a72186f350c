"""Optimized-configuration sweep (port of ``launch/sweep_optimized.py``):
every (arch × shape) cell with the §Perf levers that transferred,
counted by the dry-run on the production mesh (16x16, or 2x16x16 with
``--multi-pod``) or at one H100 (``--one-device``):

* train/prefill: causal block skipping (+ grouped MoE dispatch for MoE)
* decode: int8 KV cache (+ block skipping for prefill math), split over
  the sequence (``decode_seq_shard``) on a mesh, as the reference's
  sweep does; one device has no axis to split it over.

Writes results_dryrun_optimized.json (or the path given) with the same
schema as the dry-run, so the before/after table is a straight join::

    PYTHONPATH=src python -m repro_torch.launch.sweep_optimized \\
        [--multi-pod | --one-device] [out.json]
"""

import json
import sys
import traceback

import contextlib

from .dryrun import cells, fake_world, production_mesh, run_cell


def extras_for(cfg, shape, on_mesh: bool = True):
    e = {}
    if cfg.n_heads:                       # any attention in the stack
        e["attn_block_skip"] = True
    if cfg.n_experts:
        e["moe_groups"] = 32
    if shape.kind == "decode":
        if on_mesh:                       # one device has no axis for it
            e["decode_seq_shard"] = True
        e["kv_cache_dtype"] = "int8"
    return e


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    multi_pod = "--multi-pod" in argv
    one_device = "--one-device" in argv
    argv = [a for a in argv if a not in ("--multi-pod", "--one-device")]
    out = argv[0] if argv else "results_dryrun_optimized.json"
    results, failures = [], []
    world = (contextlib.nullcontext() if one_device
             else fake_world(512 if multi_pod else 256))
    with world:
        mesh = None if one_device else production_mesh(multi_pod)
        for cfg, shape in cells():
            extra = extras_for(cfg, shape, on_mesh=mesh is not None)
            tag = f"{cfg.name} × {shape.name}"
            try:
                rec = run_cell(cfg, shape, extra, verbose=False, mesh=mesh)
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
