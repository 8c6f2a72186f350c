"""Dry-run (port of ``launch/dryrun.py``) for one H100.

Builds every (architecture x input shape) cell's step -- the train step,
the prefill or the dense decode step -- and counts it on fake CPU
tensors (``FakeTensorMode``: shapes and dtypes, no storage, so a
full-size cell allocates nothing), then records its roofline terms at
one H100 (``roofline/analysis.py``) to JSON.

Counting needs no device: on either machine it runs on the CPU and
launches no kernel (each kernel's plain twin does the counted work, as
the kernel must).  The reference lowers each cell on a 16x16 (or
2x16x16) TPU mesh; this port's one-device dry-run reports the mesh as
``"1"`` with ``n_chips`` 1.  ``--multi-pod`` lowers the serve steps on
the production mesh, which come with sharded serving (A13b in
ROADMAP.md): it exits non-zero.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1p5-32b \\
        --shape train_4k [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --quiet \\
        --out dry.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, LONG_CONTEXT_ARCHS, get as get_arch
from ..models import params as PP
from ..models import registry
from ..roofline import analysis as RA
from ..roofline import count as C
from ..serve import serve_loop as SL
from ..train import train_loop as TL

MESH_NAME, N_CHIPS = "1", 1


def cells(only_arch=None, only_shape=None):
    for name, cfg in ARCHS.items():
        if only_arch and name != only_arch:
            continue
        for sname, shape in SHAPES.items():
            if only_shape and sname != only_shape:
                continue
            if sname == "long_500k" and name not in LONG_CONTEXT_ARCHS:
                continue  # no sub-quadratic path (DESIGN §7)
            yield cfg, shape


def lower_cell(cfg, shape, mesh=None, extra_cfg=None, tcfg=None,
               param_dtype=None, scopes=True):
    """Build one cell's step and count it on fake CPU tensors; returns
    (costs, seconds).  Train cells take the reference's production
    settings (``tcfg`` overrides them): 4 microbatches, ZeRO-1 (no-op on
    one device) and bf16 gradient compression.  Parameters are abstract
    in their declared dtype (``param_dtype`` overrides it, e.g. bf16 for
    a full-width step as the card runs it).  A step's host reads (the
    loss as a float, metrics) happen outside the counted call."""
    if mesh is not None:
        raise NotImplementedError(
            "dry-run on a mesh: the sharded serve steps come with sharded "
            "serving (A13b)")
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    t0 = time.time()
    fake = C.fake_mode()
    params = PP.abstract_params(registry.decls(cfg), fake, param_dtype)
    batch = registry.input_specs(cfg, shape, fake)
    with torch.no_grad():
        if shape.kind == "train":
            tcfg = tcfg or TL.TrainCfg(grad_accum=4, zero1=True,
                                       compress_grads=True)
            fn = TL.make_train_step(cfg, tcfg)
            opt_state = TL.abstract_opt_state(params, fake)
            with fake:
                _, costs = C.count(fn, params, opt_state, batch,
                                   scopes=scopes)
        elif shape.kind == "prefill":
            pre, _, _, _ = SL.make_serve_steps(cfg, shape.global_batch,
                                               shape.seq_len)
            with fake:
                _, costs = C.count(pre, params, batch, scopes=scopes)
        else:  # decode: one new token against a seq_len cache
            _, dec, cache, _ = SL.make_serve_steps(
                cfg, shape.global_batch, shape.seq_len, fake_mode=fake)
            with fake:
                pos = torch.full((shape.global_batch,), shape.seq_len - 1,
                                 dtype=torch.int32)
                _, costs = C.count(dec, params, cache, batch, pos,
                                   scopes=scopes)
    return costs, time.time() - t0


def run_cell(cfg, shape, multi_pod: bool = False, extra_cfg=None,
             verbose=True, scopes=True):
    """Count one cell and return its roofline record at one H100
    (``scopes``: with the per-scope attribution, ~12% of the count's
    time)."""
    if multi_pod:
        raise NotImplementedError(
            "--multi-pod: lowering on the 2x16x16 production mesh comes "
            "after sharded serving (A13b in ROADMAP.md)")
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    costs, dt = lower_cell(cfg, shape, scopes=scopes)
    roof = RA.analyze(costs, cfg, shape, MESH_NAME, N_CHIPS,
                      registry.num_active_params(cfg))
    rec = roof.to_dict(N_CHIPS)
    rec["compile_seconds"] = dt
    if verbose:
        print({"argument_bytes": costs.argument_bytes,
               "output_bytes": costs.output_bytes,
               "largest_temporary_bytes": costs.largest_alloc})
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "collectives"}, indent=1))
        print("collectives:", rec["collectives"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[None] + list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    args = ap.parse_args(argv)

    if not args.all and not args.arch:
        ap.error("pass --arch <id> or --all")
    if args.multi_pod:
        print("--multi-pod: lowering the cells on the 2x16x16 production "
              "mesh and the collective term come after sharded serving "
              "(A13b in ROADMAP.md); this dry-run counts one H100",
              file=sys.stderr)
        return 2
    arch = get_arch(args.arch).name if args.arch else None
    extra = json.loads(args.extra) if args.extra else None

    results, failures = [], []
    for cfg, shape in cells(arch, args.shape):
        tag = f"{cfg.name} × {shape.name} × {MESH_NAME}"
        try:
            rec = run_cell(cfg, shape, False, extra, verbose=not args.quiet)
            results.append(rec)
            print(f"PASS {tag}  count={rec['compile_seconds']:.1f}s "
                  f"bottleneck={rec['bottleneck']} "
                  f"bound={rec['t_bound_s']:.6g}s "
                  f"mfu_bound={rec['mfu_bound']:.4f}", flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e}", flush=True)
            if not args.quiet:
                traceback.print_exc()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} passed, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
