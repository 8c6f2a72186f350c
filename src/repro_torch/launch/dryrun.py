"""Dry-run (port of ``launch/dryrun.py``): every (architecture x input
shape) cell's step -- the train step, the prefill or the dense decode
step -- counted on fake CPU tensors (``FakeTensorMode``: shapes and
dtypes, no storage, so a full-size cell allocates nothing), with its
roofline terms at H100 rates (``roofline/analysis.py``) recorded to JSON.

Counting needs no device: on either machine it runs on the CPU and
launches no kernel (each kernel's plain twin does the counted work, as
the kernel must).  As the reference, the CLI counts each cell on the
production mesh, 16x16 over ("data", "model"), or 2x16x16 over ("pod",
"data", "model") with ``--multi-pod``: the mesh is a ``DeviceMesh`` over
a world of 256 (512) ranks of torch's ``fake`` process-group backend in
this one process (``fake_world``), the step runs on DTensors whose local
shards are one device's fake tensors, and the counter counts one
device's FLOPs, bytes and collective bytes (``count.Counter``).
``--one-device`` counts at one H100 instead (mesh ``"1"``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1p5-32b \\
        --shape train_4k [--multi-pod | --one-device] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --quiet \\
        [--multi-pod] --out dry.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, LONG_CONTEXT_ARCHS, get as get_arch
from ..distributed import sharding as SH
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


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks of torch's ``fake`` backend
    in this one process (this process is rank 0; its collectives move
    nothing), torn down on exit.  Refuses to replace a group that is
    already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool = False):
    """(mesh, name, chips): the production mesh on the ranks of the
    default group (``fake_world`` of 256 or 512)."""
    from .mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return mesh, ("2x16x16" if multi_pod else "16x16"), mesh.size()


def _on_mesh(shardings, ab, fake):
    """The abstract tree ``ab`` as DTensors placed by ``shardings`` (a tree
    of ``sharding.Sharding``s or one for every leaf), each local shard a
    fake tensor of one device's shape."""
    def leaf(path, a):
        sh = shardings if isinstance(shardings, SH.Sharding) \
            else PP.tree_at(shardings, path)
        return sh.abstract(a.shape, a.dtype, fake)
    return PP.tree_map(leaf, ab)


def _rows(mesh, batch, fake, spec=None):
    """A cell's batch with its rows over the batch axes: ``spec`` (the
    serve steps') or the train step's per-leaf spec."""
    def one(_, x):
        sp = spec if spec is not None else SH.spec_for(
            ("batch",) + (None,) * (x.dim() - 1), mesh, tuple(x.shape))
        full = SH.P(*sp, *([None] * (x.dim() - len(sp))))
        return SH.Sharding(mesh, full).abstract(x.shape, x.dtype, fake)
    return PP.tree_map(one, batch)


def lower_cell(cfg, shape, mesh=None, extra_cfg=None, tcfg=None,
               param_dtype=None, scopes=True):
    """Build one cell's step and count it on fake CPU tensors; returns
    (costs, seconds).  Train cells take the reference's production
    settings (``tcfg`` overrides them): 4 microbatches, ZeRO-1 and bf16
    gradient compression.  Parameters are abstract in their declared
    dtype (``param_dtype`` overrides it, e.g. bf16 for a full-width step
    as the card runs it).  On a ``DeviceMesh`` (of ``fake_world`` ranks,
    or real ones) parameters, optimizer state, cache and batch are
    DTensors placed as the steps place them (``make_train_step`` /
    ``make_serve_steps`` with the mesh), so the count is one device's.
    A step's host reads (the loss as a float, metrics) happen outside the
    counted call."""
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    t0 = time.time()
    fake = C.fake_mode()
    params = PP.abstract_params(registry.decls(cfg), fake, param_dtype)
    batch = registry.input_specs(cfg, shape, fake)
    b, s = shape.global_batch, shape.seq_len
    with torch.no_grad():
        if shape.kind == "train":
            tcfg = tcfg or TL.TrainCfg(grad_accum=4, zero1=True,
                                       compress_grads=True)
            opt_state = TL.abstract_opt_state(params, fake)
            if mesh is None:
                fn = TL.make_train_step(cfg, tcfg)
            else:
                fn, (p_sh, o_sh), _ = TL.make_train_step(cfg, tcfg, mesh)
                params = _on_mesh(p_sh, params, fake)
                opt_state = opt_state._replace(
                    m=_on_mesh(o_sh.m, opt_state.m, fake),
                    v=_on_mesh(o_sh.v, opt_state.v, fake))
                batch = _rows(mesh, batch, fake)
            with fake:
                _, costs = C.count(fn, params, opt_state, batch,
                                   scopes=scopes)
        else:
            pre, dec, cache, sh = SL.make_serve_steps(
                cfg, b, s, mesh, fake_mode=fake)
            if mesh is not None:
                params = _on_mesh(sh[0], params, fake)
                cache = _on_mesh(sh[1], cache, fake)
                batch = _rows(mesh, batch, fake, SL.batch_spec(mesh, b))
            if shape.kind == "prefill":
                with fake:
                    _, costs = C.count(pre, params, batch, scopes=scopes)
            else:  # decode: one new token against a seq_len cache
                with fake:
                    pos = torch.full((b,), s - 1, dtype=torch.int32)
                    _, costs = C.count(dec, params, cache, batch, pos,
                                       scopes=scopes)
    return costs, time.time() - t0


def run_cell(cfg, shape, extra_cfg=None, verbose=True, scopes=True,
             mesh=None):
    """Count one cell and return its roofline record: at one H100, or on
    ``mesh``, a ``production_mesh()`` triple (the mesh, its name and its
    chips) (``scopes``: with the per-scope attribution, ~12% of the
    count's time)."""
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    m, name, chips = mesh or (None, MESH_NAME, N_CHIPS)
    costs, dt = lower_cell(cfg, shape, m, scopes=scopes)
    roof = RA.analyze(costs, cfg, shape, name, chips,
                      registry.num_active_params(cfg))
    rec = roof.to_dict(chips)
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
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--multi-pod", action="store_true",
                       help="count on the 2x16x16 mesh (else 16x16)")
    where.add_argument("--one-device", action="store_true",
                       help="count at one H100, no mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    args = ap.parse_args(argv)

    if not args.all and not args.arch:
        ap.error("pass --arch <id> or --all")
    arch = get_arch(args.arch).name if args.arch else None
    extra = json.loads(args.extra) if args.extra else None
    world = (contextlib.nullcontext() if args.one_device
             else fake_world(512 if args.multi_pod else 256))

    results, failures = [], []
    with world:
        mesh = None if args.one_device else production_mesh(args.multi_pod)
        name = mesh[1] if mesh else MESH_NAME
        for cfg, shape in cells(arch, args.shape):
            tag = f"{cfg.name} × {shape.name} × {name}"
            try:
                rec = run_cell(cfg, shape, extra, verbose=not args.quiet,
                               mesh=mesh)
                results.append(rec)
                print(f"PASS {tag}  count={rec['compile_seconds']:.1f}s "
                      f"bottleneck={rec['bottleneck']} "
                      f"bound={rec['t_bound_s']:.6g}s "
                      f"coll={rec['collective_bytes_per_device']:.6g}B "
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
