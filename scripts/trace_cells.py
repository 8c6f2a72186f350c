"""Run a cell of the port's benchmark (``bench/``) with the program's own
tracing on, and read where the card's idle time went.

    python3 scripts/trace_cells.py spans <cell> --seed N [--seconds S]
    python3 scripts/trace_cells.py cost <cell> --seeds N1 N2 ... \
        [--seconds S] [--trace 1]
    python3 scripts/trace_cells.py interleave <cell> --seed N \
        [--seconds S] [--every K]

``spans``: one run of the cell as ``bench/run.py --trace 1`` makes it
(its profiled sub-window included, nothing judged), with
``ServeTelemetry(trace=True)`` on the batcher or a ``core.trace.Tracer``
on the train step, and a clock anchor where the sub-window starts and
where it stops.  Prints to stderr the sub-window's device idle time by
the innermost host span, the clock check (the share of kernel time
inside the spans that launch kernels, then with the spans 1 ms earlier
and 1 ms later) and the readings of ``bench/metrics/host_spans.py``
beside the cell's own per-layer readers; writes them to
``chiprun_out/trace_<cell>_<seed>.json``.

``cost``: per seed a pair of runs without the profiler (with it, and
its sub-window, under ``--trace 1``), the program's tracing off and on,
the order alternating from pair to pair; prints each run's end-to-end
metric and the medians.

``interleave``: tracing off and on in turns inside one run, so the
host's pace between runs drops out.  Serving: one run of the cell whose
batcher switches its telemetry on and off every ``--every`` iterations
of the window; per side, the decode tokens of the iterations that ran
a decode step and no prefill chunk over those iterations' time, and
the mean ``step()`` time.  Training: one step object with a tracer and
one without on the same weights and state, taking turns for
``--every`` pairs of steps; per side, the median step to its loss read.

Serving runs only need the batcher's ``telemetry=``, so ``cost`` and
``interleave`` on a serving cell also run in a checkout of an older
port.

The harness builds its batcher and its step itself; this script hands
it the traced ones by putting subclasses in place of
``ContinuousBatcher``, ``make_train_step`` and the harness's
``Profile`` for the run.  Needs a CUDA card."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

MS = 1e-3


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def traced(mode: str, state: dict, profiled: bool):
    """The harness's batcher or train step with the program's tracing
    on (the tracer in ``state["tracer"]``) and, with ``profiled``, its
    ``Profile`` anchoring the tracer at start and stop and keeping the
    kernels' absolute times (``state["kernels_ns"]``)."""
    from bench import device as D
    from bench import serve as S
    from bench import train as T
    saved = []

    def put(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if mode == "serve":
        from repro_torch.serve import batching
        from repro_torch.serve.telemetry import ServeTelemetry
        base = batching.ContinuousBatcher

        class Traced(base):
            def __init__(self, *a, **kw):
                kw["telemetry"] = ServeTelemetry(trace=True)
                super().__init__(*a, **kw)
                state["tracer"] = kw["telemetry"].tracer
        put(batching, "ContinuousBatcher", Traced)
    else:
        from repro_torch.core.trace import Tracer
        from repro_torch.train import train_loop as TL
        make = TL.make_train_step

        def make_traced(*a, **kw):
            state["tracer"] = Tracer(T.CLOCK)
            return make(*a, tracer=state["tracer"], **kw)
        put(TL, "make_train_step", make_traced)

    if profiled:
        class Anchored(D.Profile):
            def start(self):
                state["tracer"].anchor()
                super().start()
                state["profile"] = self

            def stop(self):
                super().stop()
                state["tracer"].anchor()

            def summary(self):
                from torch.autograd import DeviceType
                done = getattr(self, "_done", None)
                if done is not None:
                    kr = done.profiler.kineto_results
                    state["trace_start_ns"] = kr.trace_start_ns()
                    state["kernels_ns"] = [
                        (e.name(), e.start_ns(), e.end_ns())
                        for e in kr.events()
                        if e.device_type() == DeviceType.CUDA]
                return super().summary()
        put(S, "Profile", Anchored)
        put(T, "Profile", Anchored)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def mode_module(cell):
    if cell.traffic["mode"] == "serve":
        from bench import serve as drv
    else:
        from bench import train as drv
    return drv


def end_to_end(cell, out) -> dict:
    return {m["name"]: out["metrics"][m["name"]] for m in cell.end_to_end
            if m["name"] in out["metrics"]}


def spans_run(cell, seed: int, seconds: float, device) -> dict:
    from bench import harness
    from bench.metrics import host_spans as H
    mode = cell.traffic["mode"]
    state: dict = {}
    with traced(mode, state, profiled=True):
        out = mode_module(cell).run(cell, seed, seconds, True, device,
                               t_start=time.perf_counter(), log=log)
    tr = state["tracer"]
    ctx = dict(out["ctx"])
    prof = state["profile"]
    ctx["p0"], ctx["p1"] = prof.t0, prof.t1
    ctx["spans"] = tr.spans()
    ctx["kernels"] = [(n, tr.from_unix_ns(s), tr.from_unix_ns(e))
                      for n, s, e in state["kernels_ns"]]
    window = [(ctx["p0"], ctx["p1"])]
    by = H.idle_by_span(ctx, window)
    idle_s = sum(by.values())
    busy = H.union(H.clip(((k[1], k[2]) for k in ctx["kernels"]),
                          *window[0]))
    log(f"profiled sub-window {ctx['p1'] - ctx['p0']:.4f} s, busy "
        f"{sum(e - s for s, e in busy):.4f} s, idle {idle_s:.4f} s "
        f"(harness: busy {ctx['profile']['busy_s']:.4f} of "
        f"{ctx['profile']['window_s']:.4f} s)")
    log(f"{'innermost host span':<24}{'idle s':>10}{'share':>9}")
    for name, s in sorted(by.items(), key=lambda kv: -kv[1]):
        log(f"{name:<24}{s:>10.4f}{100 * s / idle_s:>8.2f}%")
    if mode == "serve":
        check = {f"{how} in {label}, {d:+g} ms": H.serve_alignment(
                     ctx, d * MS, names, share)
                 for how, share in (("time", H.covered_share),
                                    ("kernels", H.contained_share))
                 for label, names in (("launch|wait", H.SERVE_DEVICE),
                                      ("decode_step", H.SERVE_STEPS))
                 for d in (0, -1, 1)}
        readings = {
            "decode_span_ms.decode": H.mean_ms(ctx, "serve.decode_step"),
            "decode_launch_ms.decode": H.mean_ms(ctx,
                                                 "serve.decode.launch"),
            "batcher_host_ms.decode": H.batcher_host_ms(ctx),
            "kernels_per_decode_step.decode": H.kernels_per_decode_step(ctx),
            "idle_in_launch_share.decode": H.idle_in_launch_share(ctx)}
    else:
        check = {f"{how} in step..loss read, {d:+g} ms": H.train_alignment(
                     ctx, d * MS, share)
                 for how, share in (("time", H.covered_share),
                                    ("kernels", H.contained_share))
                 for d in (0, -1, 1)}
        readings = {
            "backward_ms.train": H.median_ms(ctx, "train.backward"),
            "optimizer_ms.train": H.median_ms(ctx, "train.optimizer"),
            "kernels_per_train_step.train": H.kernels_per_train_step(ctx),
            "idle_in_optimizer_share.train": H.idle_in_optimizer_share(ctx)}
    for k, v in check.items():
        log(f"clock check, {k}: {100 * v:.4f}%")
    own = {m["name"]: harness.reader(m["name"], cell.root)(out["ctx"])
           for m in cell.per_layer}
    for k, v in {**readings, **own}.items():
        log(f"{k}: {v}")
    names = {}
    for s in ctx["spans"]:
        names.setdefault(s["name"], []).append(s["t1"] - s["t0"])
    span_ms = {n: {"count": len(d), "mean_ms": 1e3 * statistics.mean(d)}
               for n, d in names.items()}
    return {"cell": cell.name, "seed": seed, "end_to_end": end_to_end(
                cell, out), "idle_by_span_s": by, "alignment": check,
            "readings": readings, "per_layer": own, "spans": span_ms,
            "anchors": len(tr._anchors),
            "trace_start_ns": state["trace_start_ns"]}


def cost_runs(cell, seeds, seconds: float, device, profiled: bool
              ) -> dict:
    import torch
    mode = cell.traffic["mode"]
    runs = {"off": [], "on": []}
    for i, seed in enumerate(seeds):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            state: dict = {}
            ctx = (traced(mode, state, profiled=False) if side == "on"
                   else contextlib.nullcontext())
            with ctx:
                out = mode_module(cell).run(cell, seed, seconds, profiled,
                                       device, t_start=time.perf_counter(),
                                       log=log)
            e2e = end_to_end(cell, out)
            n = len(state["tracer"]) if side == "on" else 0
            log(f"{side} seed {seed}: {e2e} ({n} trace records)")
            runs[side].append({"seed": seed, **e2e})
            del out, state, ctx
            gc.collect()
            torch.cuda.empty_cache()
    key = next(m["name"] for m in cell.end_to_end if m["name"] != "setup_s")
    med = {s: statistics.median(r[key] for r in rs) for s, rs in runs.items()}
    log(f"{key} medians: off {med['off']}, on {med['on']}, on/off "
        f"{med['on'] / med['off']}")
    return {"cell": cell.name, "metric": key, "profiled": profiled,
            "runs": runs, "median": med}


def interleave_serve(cell, seed: int, seconds: float, device,
                     every: int) -> dict:
    from repro_torch.serve import batching
    from repro_torch.serve.telemetry import ServeTelemetry
    base = batching.ContinuousBatcher
    sides = {s: {"s": 0.0, "tokens": 0, "iterations": 0, "steps": []}
             for s in ("off", "on")}

    class Toggling(base):
        """Telemetry on and off in turns of ``every`` iterations, each
        decode iteration's time and tokens booked to its side."""

        def __init__(self, *a, **kw):
            tel = ServeTelemetry(trace=True)
            super().__init__(*a, telemetry=tel, **kw)
            self._with = {"on": (tel, getattr(self, "_tracer", None)),
                          "off": (None, None)}
            self._turn("off")
            self._n, self._t, self._toks, self._chunked = 0, None, 0, False

        def _turn(self, side):
            self._side = side
            self._telemetry, tr = self._with[side]
            if hasattr(self, "_tracer"):
                self._tracer = tr

        def step(self):
            live = sum(r is not None for r in self._slot_req)
            t = time.perf_counter()
            done = super().step()
            sides[self._side]["steps"].append(time.perf_counter() - t)
            self._toks += live
            return done

        def _prefill_step(self):
            self._chunked = True
            return super()._prefill_step()

        def run(self, *a, **kw):
            window, me = self._heartbeat, self

            class Beat:
                def beat(self, worker):
                    now = time.perf_counter()
                    if (me._t is not None and window.t0 is not None
                            and me._toks and not me._chunked):
                        side = sides[me._side]
                        side["s"] += now - me._t
                        side["tokens"] += me._toks
                        side["iterations"] += 1
                    me._toks, me._chunked = 0, False
                    window.beat(worker)
                    me._n += 1
                    if me._n % every == 0:
                        me._turn("on" if me._side == "off" else "off")
                    me._t = time.perf_counter()
            self._heartbeat = Beat()
            return super().run(*a, **kw)

    batching.ContinuousBatcher = Toggling
    try:
        mode_module(cell).run(cell, seed, seconds, False, device,
                         t_start=time.perf_counter(), log=log)
    finally:
        batching.ContinuousBatcher = base
    out = {}
    for name, side in sides.items():
        st = side["steps"]
        out[name] = {"tokens_per_s": side["tokens"] / side["s"],
                     "iterations": side["iterations"],
                     "step_ms_mean": 1e3 * statistics.mean(st),
                     "step_ms_median": 1e3 * statistics.median(st)}
        log(f"{name}: {out[name]}")
    log(f"on / off tokens/s: "
        f"{out['on']['tokens_per_s'] / out['off']['tokens_per_s']}")
    return {"cell": cell.name, "seed": seed, "every": every, **out}


def interleave_train(cell, seed: int, device, pairs: int) -> dict:
    import torch
    from bench import harness
    from bench import weights as W
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels import build
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_loop as TL
    build.build_all()
    cfg = harness.port_config(cell.config)
    p = cell.traffic["params"]
    params = W.draw(cfg, seed, device, dtype=getattr(torch, cfg.dtype))
    opt_state = OPT.init(params)
    tcfg = TL.TrainCfg(opt=OPT.OptCfg(lr=p["lr"],
                                      warmup_steps=p["warmup_steps"],
                                      total_steps=p["total_steps"]))
    steps = {"off": TL.make_train_step(cfg, tcfg),
             "on": TL.make_train_step(cfg, tcfg, tracer=Tracer())}
    batch = harness.generator(cell)(p, seed, vocab=cfg.vocab_size,
                                    device=device)
    times = {"off": [], "on": []}
    for k in range(2 + 2 * pairs):
        side = ("off", "on")[(k + k // 2) % 2]
        t = time.perf_counter()
        params, opt_state, m = steps[side](params, opt_state, batch(k))
        float(m["loss"])
        if k >= 2:                      # the first two warm up
            times[side].append(time.perf_counter() - t)
    med = {s: 1e3 * statistics.median(v) for s, v in times.items()}
    log(f"train step median ms: {med}, on / off {med['on'] / med['off']}")
    return {"cell": cell.name, "seed": seed, "pairs": pairs,
            "step_ms": {s: [1e3 * x for x in v] for s, v in times.items()},
            "median_ms": med}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("spans", "cost", "interleave"))
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args(argv)
    from bench import run
    run._environment()
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    cell = harness.resolve(args.cell, ROOT)
    seconds = args.seconds or harness.load_json(
        ROOT / "BENCHMARK.json")["run_seconds"]
    device = torch.device("cuda", 0)
    if args.what == "spans":
        res = spans_run(cell, args.seed, seconds, device)
        name = f"trace_{cell.name}_{args.seed}.json"
    elif args.what == "cost":
        res = cost_runs(cell, args.seeds or [args.seed], seconds, device,
                        bool(args.trace))
        name = f"cost_{cell.name}_{args.trace}.json"
    elif cell.traffic["mode"] == "serve":
        res = interleave_serve(cell, args.seed, seconds, device, args.every)
        name = f"interleave_{cell.name}.json"
    else:
        res = interleave_train(cell, args.seed, device, args.every)
        name = f"interleave_{cell.name}.json"
    out = ROOT / "chiprun_out" / name
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
