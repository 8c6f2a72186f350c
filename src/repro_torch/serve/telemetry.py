"""Serving telemetry (port of ``serve/telemetry.py``): metrics registry,
request-lifecycle tracing, and pull surfaces (Prometheus exposition +
Chrome trace export).

hlslib's thesis is that hardware-style stacks earn production trust
through first-class *introspection* tooling — TAPA's live-FIFO peeking
during simulation is the canonical example.  This module answers "where
did this request's latency go?" with three layers:

* ``MetricsRegistry`` — named counters, gauges, and **fixed-bucket
  histograms** (TTFT, inter-token gap, prefill-chunk / decode-step /
  verify-round time, spill/restore time).  Quantiles (p50/p90/p99) are
  derived from the buckets the standard Prometheus way (linear
  interpolation inside the bucket that crosses the rank), so the
  registry never stores raw samples.  ``render_prometheus()`` emits
  text exposition format 0.0.4; ``MetricsServer`` serves it from a
  stdlib ``http.server`` daemon thread (``/metrics``, ``/healthz``).

* ``Tracer`` (``core/trace.py``, re-exported here) + ``ServeTelemetry``
  — per-request lifecycle **trace events** (submit -> admit[prefix-hit/
  CoW detail] -> prefill chunks -> first token -> decode tokens w/
  speculation accept counts -> preempt/spill/restore -> retire or typed
  terminal) and the batcher's **host spans** (``serve.iteration`` and
  its children: admit, the decode step's grow / launch / wait / emit,
  prefill chunks, verify rounds).  Everything is stamped with the
  batcher's injectable ``self._clock`` — a deterministic fake clock
  yields an exactly reconstructable trace (the telemetry tests assert
  TTFT, per-chunk prefill times, inter-token gaps, and speculation
  acceptance can be recomputed from the JSONL alone).  Export as JSONL
  (one event per line) or as a Chrome ``chrome://tracing`` /
  Perfetto-compatible trace (``to_chrome()``).  The supervisor/recovery
  path emits events under the same rid, so a replayed request's trace
  stitches to its original.  With ``profile`` each host span is also a
  ``torch.profiler.record_function`` range of its name
  (``serve.decode_step#N``, ``serve.prefill_chunk#N``,
  ``serve.verify``, ...), so a profile's device kernels line up with
  the spans.

The hot-path contract is that a disabled batcher (``telemetry=None``)
pays a single ``if`` per instrumentation point; an enabled one reads
the clock once per span boundary and records a decode step's tokens as
one run.

``percentile`` / ``percentiles`` are exact linear-interpolation
percentiles over raw samples, matching numpy's default method.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from ..core.trace import ENGINE_RID, Tracer

__all__ = [
    "percentile", "percentiles", "DEFAULT_TIME_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Tracer", "ServeTelemetry", "MetricsServer",
    "render_labels", "validate_exposition", "parse_exposition",
    "ENGINE_RID",
]

# Log-spaced latency bucket bounds in SECONDS, 100us..60s.  Wide enough
# for TTFT under long-prompt admission, fine enough that smoke-scale
# CPU decode steps (~1-10ms) land mid-range instead of in the first
# bucket.  (Prometheus-style upper bounds; +Inf is implicit.)
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


# --- percentile math (raw samples) ----------------------------------------------------


def percentile(samples: Sequence[float], q: float) -> float:
    """Exact percentile of raw samples with linear interpolation —
    numpy's default ("linear"/"inclusive") method, in pure python."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("percentile of empty sample set")
    if len(xs) == 1:
        return xs[0]
    rank = q / 100.0 * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def percentiles(samples: Sequence[float],
                qs: Iterable[float]) -> Tuple[float, ...]:
    """``percentile`` over several ranks with a single sort."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("percentiles of empty sample set")
    out = []
    for q in qs:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        rank = q / 100.0 * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        out.append(xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))
    return tuple(out)


# --- metric primitives -----------------------------------------------------------------


def render_labels(labels: Optional[Dict[str, str]]) -> str:
    """``{k="v",...}`` suffix for one exposition sample (escaped)."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace(
            '"', r'\"').replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class Counter:
    """Monotonic counter.  ``set()`` exists for the registry-sync path
    (the batcher keeps its lifetime counters as plain attributes for
    hot-path cheapness and mirrors them into the registry on collect),
    and for snapshot restore; live instrumentation uses ``inc()``."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v


class Gauge:
    """Point-in-time value (pool occupancy, live slots, queue depth)."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative exposition).

    ``bounds`` are inclusive upper bounds in ascending order; +Inf is
    implicit.  ``quantile(q)`` derives an estimate from the buckets the
    way ``histogram_quantile`` does: find the bucket whose cumulative
    count crosses ``q * count`` and interpolate linearly between its
    lower and upper bound (observations above the last finite bound
    report that bound).  No raw samples are retained, so memory is O(
    buckets) no matter the traffic."""

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        bs = tuple(float(b) for b in (buckets or DEFAULT_TIME_BUCKETS))
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"strictly ascending, got {bs}")
        self.bounds = bs
        self.counts = [0] * len(bs)       # per-bucket (non-cumulative)
        self.count = 0                    # includes > last bound
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        if i < len(self.counts):
            self.counts[i] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Bucket-derived quantile estimate, q in [0, 1].  Empty
        histogram -> NaN (a rendered 0 would read as a real latency)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q={q} outside [0, 1]")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0.0
        lo = 0.0
        for ub, c in zip(self.bounds, self.counts):
            if c and cum + c >= target:
                frac = (target - cum) / c if c else 0.0
                return lo + (ub - lo) * frac
            cum += c
            lo = ub
        return self.bounds[-1]            # +Inf bucket: report last bound

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": round(self.sum, 9),
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named metric store with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` return the existing instance
    when called again with the same name (+ labels), so call sites
    never need to cache handles — though hot paths should (attribute
    access beats a dict lookup).  A name registered as one kind cannot
    be re-registered as another."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Optional[Tuple[Tuple[str, str],
                                                      ...]]], Any] = {}
        self._kind: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: Optional[Dict[str, str]]):
        return (name, tuple(sorted(labels.items())) if labels else None)

    def _get_or_create(self, kind: str, cls, name: str, help: str,
                       labels: Optional[Dict[str, str]] = None, **kw):
        with self._lock:
            prev = self._kind.get(name)
            if prev is not None and prev != kind:
                raise ValueError(f"metric {name!r} already registered "
                                 f"as {prev}, not {kind}")
            key = self._key(name, labels)
            m = self._metrics.get(key)
            if m is None:
                m = (cls(name, help, **kw) if labels is None
                     else cls(name, help, labels=labels, **kw))
                self._metrics[key] = m
                self._kind[name] = kind
                if help:
                    self._help.setdefault(name, help)
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create("counter", Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create("gauge", Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create("histogram", Histogram, name, help,
                                   None, buckets=buckets)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self._metrics.get(self._key(name, labels))

    def as_dict(self) -> Dict[str, Any]:
        """Plain-number snapshot (histograms -> their summaries)."""
        out: Dict[str, Any] = {}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), m in items:
            key = name + render_labels(dict(labels) if labels else None)
            out[key] = (m.summary() if isinstance(m, Histogram)
                        else m.value)
        return out

    def render_prometheus(self) -> str:
        """Text exposition format 0.0.4 — one # HELP/# TYPE pair per
        metric name, cumulative ``_bucket``/``_sum``/``_count`` series
        for histograms."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0][0])
            kinds = dict(self._kind)
            helps = dict(self._help)
        lines: List[str] = []
        seen_header = set()
        for (name, _labels), m in items:
            if name not in seen_header:
                seen_header.add(name)
                h = helps.get(name, "")
                if h:
                    lines.append(f"# HELP {name} {h}")
                lines.append(f"# TYPE {name} {kinds[name]}")
            if isinstance(m, Histogram):
                cum = 0
                for ub, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(ub)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name}{render_labels(m.labels)} "
                             f"{_fmt(m.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Exposition value formatting: integral floats render bare."""
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf",
                float("-inf"): "-Inf"}.get(f, "NaN")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# --- exposition validation (CI smoke + round-trip tests) -------------------------------

import re as _re

_SAMPLE_RE = _re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(\{[^{}]*\})?"                        # optional labels
    r" ([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")


def parse_exposition(text: str) -> Dict[str, float]:
    """Parse exposition text back to ``{name{labels}: value}`` —
    the round-trip half of ``validate_exposition``."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition sample: {line!r}")
        val = m.group(3)
        out[m.group(1) + (m.group(2) or "")] = float(
            val.replace("Inf", "inf").replace("NaN", "nan"))
    return out


def validate_exposition(text: str) -> Dict[str, float]:
    """Validate Prometheus text-format invariants and return the parsed
    samples.  Checks: every sample parses; every sample's base name was
    declared by a preceding ``# TYPE``; histograms expose a ``+Inf``
    bucket whose value equals ``_count``; bucket series are cumulative
    (non-decreasing).  Raises ``ValueError`` with the offending line."""
    typed: Dict[str, str] = {}
    samples: List[Tuple[str, Optional[str], float]] = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                raise ValueError(f"malformed TYPE line: {line!r}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition sample: {line!r}")
        name, labels, val = m.group(1), m.group(2), m.group(3)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
                break
        if base not in typed:
            raise ValueError(f"sample {name!r} has no preceding # TYPE")
        samples.append((name, labels, float(
            val.replace("Inf", "inf").replace("NaN", "nan"))))
    # histogram invariants
    by_hist: Dict[str, List[float]] = {}
    counts: Dict[str, float] = {}
    infs: Dict[str, float] = {}
    for name, labels, v in samples:
        if name.endswith("_bucket") and name[:-7] in typed:
            h = name[:-7]
            by_hist.setdefault(h, []).append(v)
            if labels and 'le="+Inf"' in labels:
                infs[h] = v
        elif name.endswith("_count") and name[:-6] in typed \
                and typed[name[:-6]] == "histogram":
            counts[name[:-6]] = v
    for h, buckets in by_hist.items():
        if typed.get(h) != "histogram":
            continue
        if h not in infs:
            raise ValueError(f"histogram {h!r} missing +Inf bucket")
        if buckets != sorted(buckets):
            raise ValueError(f"histogram {h!r} buckets not cumulative")
        if h in counts and counts[h] != infs[h]:
            raise ValueError(f"histogram {h!r}: _count {counts[h]} != "
                             f"+Inf bucket {infs[h]}")
    return {n + (l or ""): v for n, l, v in samples}


# --- the serving telemetry facade ------------------------------------------------------


class ServeTelemetry:
    """One object the batcher stack shares: a ``MetricsRegistry``, a
    ``Tracer`` (optional), the latency histograms, and the per-request
    bookkeeping that turns raw stamps into TTFT / inter-token-gap
    observations.  Constructed by the caller and passed to
    ``ContinuousBatcher(telemetry=...)``; the batcher binds its
    injectable clock into it so traces are deterministic under a fake
    clock.  Every ``note_*`` hook is called behind the batcher's
    ``if self._telemetry`` guard — a disabled batcher pays one ``if``
    per site.

    ``tracer`` (with ``trace``) takes the lifecycle events and the
    batcher's host spans; ``spans`` is the tracer the batcher opens its
    spans on: ``tracer`` itself, or with ``profile`` alone one that
    keeps no lifecycle, so the profiler's ranges still come from the
    spans.  ``profile`` opens a ``torch.profiler`` range per span."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 trace: bool = True, registry: Optional[MetricsRegistry]
                 = None, max_events: int = 1_000_000,
                 profile: bool = False):
        self.clock = clock or time.monotonic
        self.metrics = registry or MetricsRegistry()
        spans = (Tracer(self.clock, max_events, profile=profile)
                 if trace or profile else None)
        self.tracer: Optional[Tracer] = spans if trace else None
        self.spans: Optional[Tracer] = spans
        self._collectors: List[Callable[[], None]] = []
        self._t_submit: Dict[int, float] = {}
        self._t_last_tok: Dict[int, float] = {}
        h = self.metrics.histogram
        self.h_ttft = h("serve_ttft_seconds",
                        "submit to first streamed token")
        self.h_gap = h("serve_inter_token_seconds",
                       "gap between consecutive streamed tokens of one "
                       "request")
        # the help texts are the reference's, so both expositions match.
        self.h_chunk = h("serve_prefill_chunk_seconds",
                         "one chunked-prefill jit call")
        self.h_step = h("serve_decode_step_seconds",
                        "one batched decode jit call")
        self.h_verify = h("serve_verify_round_seconds",
                          "one speculative verify jit call")
        self.h_spill = h("serve_spill_seconds",
                         "preemption spill (staged gather) per request")
        self.h_restore = h("serve_restore_seconds",
                           "preemption restore (staged scatter) per "
                           "request")
        self.h_gather = h("serve_transfer_gather_seconds",
                          "staged transfer-engine device->host gather")
        self.h_scatter = h("serve_transfer_scatter_seconds",
                           "staged transfer-engine host->device scatter")
        self.c_submitted = self.metrics.counter(
            "serve_requests_submitted_total",
            "requests accepted into the queue")

    # -- wiring -------------------------------------------------------------------

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Adopt the batcher's injectable clock (the batcher calls this
        at construction so every stamp shares one time base)."""
        self.clock = clock
        if self.spans is not None:
            self.spans.bind(clock)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a sync callback run before every registry read
        (render/snapshot) — the batcher mirrors its plain-attribute
        lifetime counters into the registry here, keeping increments
        off the hot path."""
        if fn not in self._collectors:
            self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def render_prometheus(self) -> str:
        self.collect()
        return self.metrics.render_prometheus()

    def snapshot(self) -> Dict[str, Any]:
        self.collect()
        return self.metrics.as_dict()

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """Bucket-derived p50/p90/p99 per latency histogram — the
        ``stats()["latency"]`` payload."""
        return {
            "ttft": self.h_ttft.summary(),
            "inter_token": self.h_gap.summary(),
            "prefill_chunk": self.h_chunk.summary(),
            "decode_step": self.h_step.summary(),
            "verify_round": self.h_verify.summary(),
            "spill": self.h_spill.summary(),
            "restore": self.h_restore.summary(),
        }

    # -- raw event surface --------------------------------------------------------

    def event(self, rid: int, name: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.event(rid, name, **args)

    def span(self, rid: int, name: str, t0: float, t1: float,
             **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.span(rid, name, t0, t1, **args)

    # -- lifecycle hooks (called by the batcher stack) ------------------------------

    def note_submit(self, req: Any) -> None:
        self._t_submit[req.rid] = req.submitted_at
        self.c_submitted.inc()
        if self.tracer is not None:
            self.tracer.event(
                req.rid, "submit", ts=req.submitted_at,
                klass=req.klass, prompt_len=int(len(req.prompt)),
                max_new=int(req.max_new),
                **({"deadline_ms": req.deadline_ms}
                   if req.deadline_ms is not None else {}))

    def note_admit(self, req: Any, slot: int, *, prefix_hit_tokens: int,
                   cow: bool, start: int, n_chunks: int,
                   resume: bool) -> None:
        now = self.clock()
        sub = self._t_submit.get(req.rid)
        args: Dict[str, Any] = {
            "slot": slot, "prefix_hit_tokens": int(prefix_hit_tokens),
            "cow": bool(cow), "start": int(start),
            "n_chunks": int(n_chunks), "resume": bool(resume)}
        if sub is not None:
            args["queue_s"] = now - sub
        if self.tracer is not None:
            self.tracer.event(req.rid, "admit", ts=now, **args)

    def note_chunk(self, rid: int, slot: int, chunk: int, t0: float,
                   t1: float, *, base: int, final: bool) -> None:
        self.h_chunk.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.span(rid, "prefill_chunk", t0, t1, slot=slot,
                             chunk=chunk, base=base, final=final)

    def note_first_token(self, rid: int, slot: int, ts: float,
                         pos: int) -> None:
        sub = self._t_submit.get(rid)
        if sub is not None:
            self.h_ttft.observe(ts - sub)
        self._t_last_tok[rid] = ts
        if self.tracer is not None:
            args = {"slot": slot, "pos": pos}
            if sub is not None:
                args["ttft_s"] = ts - sub
            self.tracer.event(rid, "first_token", ts=ts, **args)
            self.tracer.token(rid, slot, pos, ts)

    def note_token(self, rid: int, slot: int, ts: float,
                   pos: int) -> None:
        last = self._t_last_tok.get(rid)
        if last is not None:
            self.h_gap.observe(ts - last)
        self._t_last_tok[rid] = ts
        if self.tracer is not None:
            self.tracer.token(rid, slot, pos, ts)

    def note_decode_step(self, t0: float, t1: float,
                         n_live: int) -> None:
        self.h_step.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.span(ENGINE_RID, "decode_step", t0, t1,
                             n_live=n_live)

    def note_verify_round(self, t0: float, t1: float,
                          n_drafting: int) -> None:
        self.h_verify.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.span(ENGINE_RID, "verify_round", t0, t1,
                             n_drafting=n_drafting)

    def note_spec(self, rid: int, slot: int, drafted: int,
                  accepted: int) -> None:
        if self.tracer is not None:
            self.tracer.event(rid, "spec_verify", slot=slot,
                              drafted=int(drafted), accepted=int(accepted),
                              rolled_back=int(drafted - accepted))

    def note_preempt(self, rid: int, slot: int, pos: int,
                     mode: str) -> None:
        if self.tracer is not None:
            self.tracer.event(rid, "preempt", slot=slot, pos=int(pos),
                              mode=mode)

    def note_spill(self, rid: int, t0: float, t1: float) -> None:
        self.h_spill.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.span(rid, "spill", t0, t1)

    def note_restore(self, rid: int, t0: float, t1: float) -> None:
        self.h_restore.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.span(rid, "restore", t0, t1)

    def note_resume(self, rid: int, slot: int, mode: str) -> None:
        if self.tracer is not None:
            self.tracer.event(rid, "resume", slot=slot, mode=mode)

    def note_retire(self, rid: int, slot: Optional[int] = None) -> None:
        now = self.clock()
        sub = self._t_submit.pop(rid, None)
        self._t_last_tok.pop(rid, None)
        if self.tracer is not None:
            args = {} if slot is None else {"slot": slot}
            self.tracer.event(rid, "retire", ts=now, **args)
            if sub is not None:
                self.tracer.span(rid, "request", sub, now,
                                 outcome="retired")

    def note_terminal(self, rid: int, kind: str, reason: str) -> None:
        now = self.clock()
        sub = self._t_submit.pop(rid, None)
        self._t_last_tok.pop(rid, None)
        if self.tracer is not None:
            self.tracer.event(rid, kind, ts=now, reason=reason)
            if sub is not None:
                self.tracer.span(rid, "request", sub, now, outcome=kind)

    def note_recover_journal(self, rid: int, pos: int, mode: str,
                             restart: int) -> None:
        """Crash recovery journals this request for replay; the replay's
        later events carry the same rid, so the trace stitches to the
        pre-fault events (the test asserts monotonic continuity)."""
        if self.tracer is not None:
            self.tracer.event(rid, "recover_journal", pos=int(pos),
                              mode=mode, restart=int(restart))


# --- stdlib metrics endpoint -----------------------------------------------------------


class MetricsServer:
    """``http.server`` pull endpoint in a daemon thread.

    * ``GET /metrics``  -> Prometheus text exposition (0.0.4)
    * ``GET /healthz``  -> ``ok``

    ``port=0`` binds an ephemeral port (``.port`` reports the real one
    after ``start()``).  ``source`` is anything with
    ``render_prometheus()`` — a ``ServeTelemetry`` (collectors run per
    scrape) or a bare ``MetricsRegistry``."""

    def __init__(self, source: Any, port: int = 0,
                 host: str = "127.0.0.1"):
        self.source = source
        self.host = host
        self.port = int(port)
        self._server: Optional[Any] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        import http.server

        source = self.source

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):             # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] == "/metrics":
                    try:
                        body = source.render_prometheus().encode()
                    except Exception as e:   # a scrape must never 500-loop
                        self.send_error(500, f"{type(e).__name__}: {e}")
                        return
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.split("?")[0] == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):     # silence per-scrape stderr
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
