"""Readings of the program's host spans (``repro_torch.core.trace``)
beside the card's kernel intervals, on one clock.

A context for them holds, besides a run's usual keys, ``spans`` (the
tracer's closed spans: ``id``, ``parent``, ``name``, ``t0``, ``t1`` on
the harness's clock, ``args``) and ``kernels`` ((name, start, end) of
every kernel and copy the profiler recorded, put on the same clock
through the tracer's anchors).  Host-time readings take the window's
spans outside the profiled sub-window [``p0``, ``p1``], as
``spans.py``'s do; device readings take the sub-window, or the profiled
train steps.  Idle time is put down to the innermost span the host was
in; time in no span is ``OUTSIDE``."""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

OUTSIDE = "(no span)"
COPIES = ("Memcpy", "Memset")
# the spans a serving kernel is launched in, the decode step whole
SERVE_STEPS = ("serve.admit", "serve.grow", "serve.decode_step",
               "serve.prefill_chunk")
# the same with a decode step cut to its launch and its wait: a step's
# kernels start after its launch begins and end before its wait ends,
# so these leave out the stretches (the emit, the loop between
# iterations) in which the card should run nothing of the step
SERVE_DEVICE = ("serve.admit", "serve.grow", "serve.decode.launch",
                "serve.decode.wait", "serve.verify", "serve.prefill_chunk")

Interval = Tuple[float, float]


def union(iv: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering ``iv``."""
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(iv: Iterable[Interval], w0: float, w1: float) -> List[Interval]:
    return [(max(s, w0), min(e, w1)) for s, e in iv if e > w0 and s < w1]


def idle(kernels, w0: float, w1: float) -> List[Interval]:
    """Stretches of [w0, w1] in which no kernel or copy ran."""
    out, t = [], w0
    for s, e in union(clip(((k[1], k[2]) for k in kernels), w0, w1)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def segments(spans) -> List[Tuple[float, float, str]]:
    """(t0, t1, name) pieces of the time the spans cover, each under
    its innermost span (spans of one thread nest)."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s["t0"], -s["t1"])):
        while stack and stack[-1]["t1"] <= s["t0"]:
            top = stack.pop()
            out.append((t, top["t1"], top["name"]))
            t = top["t1"]
        if stack:
            out.append((t, s["t0"], stack[-1]["name"]))
        stack.append(s)
        t = s["t0"]
    while stack:
        top = stack.pop()
        out.append((t, top["t1"], top["name"]))
        t = top["t1"]
    return [p for p in out if p[1] > p[0]]


def overlap_by_name(pieces: Sequence[Interval], segs) -> Dict[str, float]:
    """Seconds of ``pieces`` under each segment's name; the rest under
    ``OUTSIDE``."""
    got: Dict[str, float] = {}
    starts = [g[0] for g in segs]
    for s, e in pieces:
        inside = 0.0
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(segs) and segs[k][0] < e:
            a, b, name = segs[k]
            o = min(b, e) - max(a, s)
            if o > 0:
                got[name] = got.get(name, 0.0) + o
                inside += o
            k += 1
        if e - s - inside > 0:
            got[OUTSIDE] = got.get(OUTSIDE, 0.0) + (e - s - inside)
    return got


def idle_by_span(ctx, windows: Sequence[Interval]) -> Dict[str, float]:
    """The device's idle seconds in ``windows`` by the innermost span
    the host was in."""
    pieces = [p for w0, w1 in windows for p in idle(ctx["kernels"], w0, w1)]
    return overlap_by_name(pieces, segments(ctx["spans"]))


def covered_share(kernels, cover: Iterable[Interval],
                  windows: Sequence[Interval], shift: float = 0.0) -> float:
    """Share of the kernels' and copies' time in ``windows`` that lies
    inside ``cover`` moved by ``shift`` seconds."""
    cov = union((s + shift, e + shift) for s, e in cover)
    starts = [c[0] for c in cov]
    total = inside = 0.0
    for w0, w1 in windows:
        for s, e in clip(((k[1], k[2]) for k in kernels), w0, w1):
            total += e - s
            k = max(bisect.bisect_right(starts, s) - 1, 0)
            while k < len(cov) and cov[k][0] < e:
                inside += max(0.0, min(cov[k][1], e) - max(cov[k][0], s))
                k += 1
    return inside / total if total else 0.0


def contained_share(kernels, cover: Iterable[Interval],
                    windows: Sequence[Interval], shift: float = 0.0
                    ) -> float:
    """Share of the kernels and copies starting in ``windows`` that lie
    wholly inside one stretch of ``cover`` moved by ``shift`` seconds:
    a count, so the many short kernels at a step's edges weigh as much
    as its long ones, and a kernel that starts before its span or ends
    after it counts against it."""
    cov = union((s + shift, e + shift) for s, e in cover)
    starts = [c[0] for c in cov]
    n = inside = 0
    for w0, w1 in windows:
        for k in kernels:
            if w0 <= k[1] <= w1:
                n += 1
                i = bisect.bisect_right(starts, k[1]) - 1
                inside += i >= 0 and k[2] <= cov[i][1]
    return inside / n if n else 0.0


def kernel_count(kernels, t0: float, t1: float) -> int:
    """Kernels (copies left out) that start in [t0, t1]."""
    return sum(1 for k in kernels
               if t0 <= k[1] <= t1 and not k[0].startswith(COPIES))


def named(ctx, name: str) -> List[Dict]:
    return [s for s in ctx.get("spans") or () if s["name"] == name]


# --- serving -----------------------------------------------------------------------


def _sub_window(ctx) -> Optional[Interval]:
    if ctx.get("p0") is None or not ctx.get("kernels"):
        return None
    return ctx["p0"], ctx["p1"]


def host_spans(ctx, name: str) -> List[Dict]:
    """Spans ``name`` inside the window and outside the profiled
    sub-window."""
    t0, t1 = ctx["t0"], ctx["t1"]
    p0, p1 = ctx.get("p0"), ctx.get("p1")
    return [s for s in named(ctx, name) if s["t0"] >= t0 and s["t1"] <= t1
            and (p0 is None or s["t1"] <= p0 or s["t0"] >= p1)]


def mean_ms(ctx, name: str) -> Optional[float]:
    ss = host_spans(ctx, name)
    return (sum(s["t1"] - s["t0"] for s in ss) / len(ss) * 1e3
            if ss else None)


def batcher_host_ms(ctx) -> Optional[float]:
    """Mean per decode iteration (one holding a decode step and no
    prefill chunk) of its admit, grow and emit spans, in ms."""
    kids: Dict[int, List[Dict]] = {}
    by_id = {s["id"]: s for s in ctx.get("spans") or ()}
    for s in by_id.values():
        kids.setdefault(s["parent"], []).append(s)
    total, n = 0.0, 0
    for it in host_spans(ctx, "serve.iteration"):
        inner = list(kids.get(it["id"], ()))
        names = [s["name"] for s in inner]
        if "serve.decode_step" not in names or "serve.prefill_chunk" in names:
            continue
        for s in list(inner):
            inner.extend(kids.get(s["id"], ()))
        total += sum(s["t1"] - s["t0"] for s in inner if s["name"] in (
            "serve.admit", "serve.grow", "serve.decode.emit"))
        n += 1
    return total / n * 1e3 if n else None


def kernels_per_decode_step(ctx) -> Optional[float]:
    """Kernels starting inside each decode step span wholly in the
    profiled sub-window, per step."""
    w = _sub_window(ctx)
    if w is None:
        return None
    ss = [s for s in named(ctx, "serve.decode_step")
          if s["t0"] >= w[0] and s["t1"] <= w[1]]
    if not ss:
        return None
    return sum(kernel_count(ctx["kernels"], s["t0"], s["t1"])
               for s in ss) / len(ss)


def idle_share_in(ctx, name: str, windows: Sequence[Interval]
                  ) -> Optional[float]:
    """Share (%) of the idle time in ``windows`` while the host's
    innermost span was ``name``."""
    by = idle_by_span(ctx, windows)
    total = sum(by.values())
    return 100.0 * by.get(name, 0.0) / total if total > 0 else None


def idle_in_launch_share(ctx) -> Optional[float]:
    w = _sub_window(ctx)
    return idle_share_in(ctx, "serve.decode.launch", [w]) if w else None


def serve_alignment(ctx, shift: float = 0.0,
                    names: Sequence[str] = SERVE_DEVICE,
                    share=covered_share) -> Optional[float]:
    """Share of the sub-window's kernel time (or with ``contained_share``
    of its kernels) inside the spans ``names``, the spans moved by
    ``shift`` seconds."""
    w = _sub_window(ctx)
    if w is None:
        return None
    cover = [(s["t0"], s["t1"]) for s in ctx["spans"] if s["name"] in names]
    return share(ctx["kernels"], cover, [w], shift)


# --- training ------------------------------------------------------------------------


def step_intervals(ctx, profiled: bool) -> List[Interval]:
    """Each timed step's interval from its ``train.step`` span's start
    to the end of the harness's read of its loss."""
    out = []
    tops = named(ctx, "train.step")
    for st in ctx.get("steps") or ():
        if st["profiled"] != profiled:
            continue
        sp = [s for s in tops if st["start"] <= s["t0"] <= st["end"]]
        if sp:
            out.append((sp[0]["t0"], st["end"]))
    return out


def median_ms(ctx, name: str) -> Optional[float]:
    """Median span ``name`` inside the steps outside the profiled ones,
    in ms."""
    steps = step_intervals(ctx, profiled=False)
    ds = [s["t1"] - s["t0"] for s in named(ctx, name)
          if any(a <= s["t0"] <= b for a, b in steps)]
    return statistics.median(ds) * 1e3 if ds else None


def kernels_per_train_step(ctx) -> Optional[float]:
    steps = step_intervals(ctx, profiled=True) if ctx.get("kernels") else []
    if not steps:
        return None
    return sum(kernel_count(ctx["kernels"], a, b)
               for a, b in steps) / len(steps)


def idle_in_optimizer_share(ctx) -> Optional[float]:
    steps = step_intervals(ctx, profiled=True) if ctx.get("kernels") else []
    return idle_share_in(ctx, "train.optimizer", steps) if steps else None


def train_alignment(ctx, shift: float = 0.0, share=covered_share
                    ) -> Optional[float]:
    """Share of the profiled window's kernel time (or with
    ``contained_share`` of its kernels) inside the profiled steps'
    intervals moved by ``shift`` seconds."""
    steps = step_intervals(ctx, profiled=True) if ctx.get("kernels") else []
    if not steps:
        return None
    return share(ctx["kernels"], steps, [(ctx["p0"], ctx["p1"])], shift)
