"""One trace for serving and training: lifecycle events and nested host
spans on one injectable clock, with anchors that put it on the
profiler's clock.

``Tracer`` keeps two records.  **Events** are the request lifecycle the
serving telemetry writes (``event``, ``span``, ``token``): instants and
complete spans of one request or of the engine (``ENGINE_RID``).  A
decode step's tokens, all stamped when the host holds them, go in as one
record per run of consecutive tokens (their rids, slots and positions),
not one dict each; ``events``, ``to_jsonl`` and ``to_chrome`` expand a
run into the per-token events it stands for, in order.

**Host spans** mark where a loop's host time goes: ``open(name)``
returns a ``Span`` whose parent is the span open when it began and whose
``owner`` (a request or step id) it inherits unless given;
``span.close()`` ends it and any span still open inside it (one left
open by an exception).  A span is also a context manager.  Spans nest on
the thread that runs the loop; events may come from any thread.  With
``profile`` every span also opens the ``torch.profiler`` range of its
name (``name#number`` where a number is given), so a profile's ranges
are the spans.

Stamps are the clock's own, so a fake clock keeps a trace exact.
``anchor()`` records a pair (clock, ``time.time_ns()``), taken when the
first span opens and whenever a caller asks (around a profiled window);
a new clock (``bind``) forgets them.  ``to_unix_ns`` and
``from_unix_ns`` map between the two by linear interpolation between
the two anchors nearest the time, and
``spans(unix=True)`` gives the spans in the ``time_ns`` domain, in which
Kineto's absolute event times (``trace_start_ns()``) lie on Linux.

A caller that traces nothing holds ``None`` instead of a tracer and pays
one ``is None`` check per site: no clock read, no object.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch.profiler import record_function

__all__ = ["ENGINE_RID", "Span", "Tracer"]

# Engine-level (not per-request) events carry this rid; Chrome export
# maps it to its own track, and host spans are written under it.
ENGINE_RID = -1


class _TokenRun:
    """Consecutive token events stamped at one time: one decode step's
    tokens up to the next other event."""

    __slots__ = ("ts", "rids", "slots", "pos")

    def __init__(self, ts: float):
        self.ts = ts
        self.rids: List[int] = []
        self.slots: List[int] = []
        self.pos: List[int] = []

    def expand(self) -> List[Dict[str, Any]]:
        return [{"ts": self.ts, "rid": r, "name": "token", "ph": "i",
                 "args": {"slot": s, "pos": p}}
                for r, s, p in zip(self.rids, self.slots, self.pos)]


class Span:
    """One host span: ``name``, ``t0`` / ``t1`` on the tracer's clock
    (``t1`` None while open), its ``id`` (-1 when the tracer was full),
    its ``parent``'s id (-1 at the top), its ``owner`` and its counters
    (``args``)."""

    __slots__ = ("tracer", "name", "t0", "t1", "id", "parent", "owner",
                 "args", "_range")

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, **args: Any) -> float:
        """End the span (and any still open inside it); ``args`` become
        its counters.  Returns the end stamp."""
        return self.tracer._close(self, args)


class Tracer:
    """Append-only lifecycle events and host spans, stamped with an
    injectable clock.  Capped at ``max_events`` events and spans
    together (a run of tokens counts each token); overflow drops new
    ones and counts them (``dropped``) instead of growing without
    bound."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 1_000_000, profile: bool = False):
        self.clock = clock or time.monotonic
        self.max_events = int(max_events)
        self.profile = bool(profile)
        self.dropped = 0
        self._events: List[Any] = []        # event dicts and _TokenRuns
        self._n_events = 0                  # a run counts its tokens
        self._spans: List[Span] = []
        self._open: List[Span] = []         # innermost last
        self._anchors: List[Tuple[float, int]] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n_events + len(self._spans)

    def _full(self) -> bool:
        return self._n_events + len(self._spans) >= self.max_events

    # -- lifecycle events -------------------------------------------------------------

    def _append(self, e: Dict[str, Any]) -> None:
        with self._lock:
            if self._full():
                self.dropped += 1
                return
            self._events.append(e)
            self._n_events += 1

    def event(self, rid: int, name: str, ts: Optional[float] = None,
              **args: Any) -> None:
        """An instant (``"i"``) event at ``ts`` (now if None)."""
        e: Dict[str, Any] = {"ts": self.clock() if ts is None else ts,
                             "rid": rid, "name": name, "ph": "i"}
        if args:
            e["args"] = args
        self._append(e)

    def span(self, rid: int, name: str, t0: float, t1: float,
             **args: Any) -> None:
        """A complete (``"X"``) lifecycle span of request ``rid``."""
        e: Dict[str, Any] = {"ts": t0, "dur": t1 - t0, "rid": rid,
                             "name": name, "ph": "X"}
        if args:
            e["args"] = args
        self._append(e)

    def token(self, rid: int, slot: int, pos: int, ts: float) -> None:
        """The ``token`` event of ``rid``: joins the run of tokens just
        recorded at the same stamp, or starts one."""
        with self._lock:
            if self._full():
                self.dropped += 1
                return
            run = self._events[-1] if self._events else None
            if not isinstance(run, _TokenRun) or run.ts != ts:
                run = _TokenRun(ts)
                self._events.append(run)
            run.rids.append(rid)
            run.slots.append(slot)
            run.pos.append(pos)
            self._n_events += 1

    def events(self, rid: Optional[int] = None) -> List[Dict[str, Any]]:
        """The lifecycle events in order, token runs expanded (host
        spans are in ``spans``)."""
        with self._lock:
            items = list(self._events)
        evs: List[Dict[str, Any]] = []
        for e in items:
            if isinstance(e, _TokenRun):
                evs.extend(e.expand())
            else:
                evs.append(e)
        if rid is None:
            return evs
        return [e for e in evs if e["rid"] == rid]

    def clear(self) -> None:
        """Drop every event and span (the anchors stay)."""
        with self._lock:
            self._events.clear()
            self._n_events = 0
            self._spans.clear()
            self._open.clear()
            self.dropped = 0

    # -- host spans -------------------------------------------------------------------

    def open(self, name: str, owner: Optional[int] = None,
             number: Optional[int] = None,
             at: Optional[float] = None) -> Span:
        """Begin span ``name`` now (or at ``at``, a stamp just read, so
        back-to-back spans share it), inside the innermost open span."""
        if not self._anchors:
            self.anchor()
        sp = Span()
        sp.tracer = self
        sp.name = name
        sp.t0 = self.clock() if at is None else at
        sp.t1 = None
        sp.args = None
        top = self._open[-1] if self._open else None
        sp.parent = top.id if top is not None else -1
        sp.owner = owner if owner is not None or top is None else top.owner
        with self._lock:
            if self._full():
                self.dropped += 1
                sp.id = -1
            else:
                sp.id = len(self._spans)
                self._spans.append(sp)
        self._open.append(sp)
        sp._range = None
        if self.profile:
            sp._range = record_function(
                name if number is None else f"{name}#{number}")
            sp._range.__enter__()
        return sp

    def _close(self, sp: Span, args: Dict[str, Any]) -> float:
        if args:
            sp.args = dict(sp.args or {}, **args)
        if sp.t1 is not None:
            return sp.t1
        t = self.clock()
        stack = self._open
        while stack:
            inner = stack.pop()
            inner.t1 = t
            if inner._range is not None:
                inner._range.__exit__(None, None, None)
                inner._range = None
            if inner is sp:
                break
        return t

    def spans(self, unix: bool = False) -> List[Dict[str, Any]]:
        """The closed host spans: ``id``, ``parent``, ``owner``,
        ``name``, ``t0``, ``t1`` and ``args`` (counters), in the order
        they began; with ``unix`` the stamps in ``time.time_ns()``
        nanoseconds."""
        with self._lock:
            done = [s for s in self._spans if s.t1 is not None]
        conv = self.to_unix_ns if unix else (lambda t: t)
        return [{"id": s.id, "parent": s.parent, "owner": s.owner,
                 "name": s.name, "t0": conv(s.t0), "t1": conv(s.t1),
                 "args": dict(s.args or {})} for s in done]

    # -- clock anchors ----------------------------------------------------------------

    def anchor(self) -> Tuple[float, int]:
        """Record and return a pair (clock, ``time.time_ns()``): the
        clock read between two ``time_ns`` reads, paired with their
        midpoint."""
        a = time.time_ns()
        t = self.clock()
        b = time.time_ns()
        pair = (t, (a + b) // 2)
        with self._lock:
            self._anchors.append(pair)
            self._anchors.sort()
        return pair

    def bind(self, clock: Callable[[], float]) -> None:
        """Stamp with ``clock`` from now on; the anchors of the old
        clock are forgotten."""
        self.clock = clock
        with self._lock:
            self._anchors.clear()

    def _pair(self, xs: List[float], x: float) -> Tuple[int, int]:
        """Indices of the two anchors nearest ``x`` along ``xs``."""
        k = bisect.bisect_right(xs, x)
        k = min(max(k, 1), len(xs) - 1)
        return k - 1, k

    def to_unix_ns(self, t: float) -> float:
        """Clock stamp ``t`` in ``time.time_ns()`` nanoseconds."""
        A = self._anchors
        if len(A) == 1:
            return A[0][1] + (t - A[0][0]) * 1e9
        i, j = self._pair([a[0] for a in A], t)
        (t0, n0), (t1, n1) = A[i], A[j]
        return n0 + (t - t0) * (n1 - n0) / (t1 - t0)

    def from_unix_ns(self, ns: float) -> float:
        """``time.time_ns()`` nanoseconds on the clock (the inverse of
        ``to_unix_ns``)."""
        A = self._anchors
        if len(A) == 1:
            return A[0][0] + (ns - A[0][1]) / 1e9
        i, j = self._pair([a[1] for a in A], ns)
        (t0, n0), (t1, n1) = A[i], A[j]
        return t0 + (ns - n0) * (t1 - t0) / (n1 - n0)

    # -- exports ----------------------------------------------------------------------

    def _span_events(self) -> List[Dict[str, Any]]:
        """Host spans as complete events under ``ENGINE_RID``, their id,
        parent and owner among the args."""
        return [{"ts": s["t0"], "dur": s["t1"] - s["t0"], "rid": ENGINE_RID,
                 "name": s["name"], "ph": "X",
                 "args": dict(s["args"], span=s["id"], parent=s["parent"],
                              owner=s["owner"])}
                for s in self.spans()]

    def to_jsonl(self) -> str:
        """One JSON object per line: the lifecycle events, then the host
        spans."""
        return "\n".join(json.dumps(e, sort_keys=True)
                         for e in self.events() + self._span_events())

    def write_jsonl(self, path: str) -> int:
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text + "\n" if text else "")
        return len(text.splitlines())

    def to_chrome(self) -> Dict[str, Any]:
        """``chrome://tracing`` / Perfetto trace: the lifecycle on pid 0,
        one tid per request (engine-level events on tid 0), the host
        spans on pid 1 tid 0, where they nest.  Timestamps scale to
        microseconds as the format demands."""
        out = []
        spans = self._span_events()
        for pid, evs in ((0, self.events()), (1, spans)):
            for e in evs:
                tid = 0 if e["rid"] == ENGINE_RID else e["rid"] + 1
                ce: Dict[str, Any] = {
                    "name": e["name"], "ph": e["ph"],
                    "cat": "serve" if pid == 0 else "host",
                    "ts": e["ts"] * 1e6, "pid": pid, "tid": tid,
                    "args": dict(e.get("args", {})),
                }
                ce["args"]["rid"] = e["rid"]
                if e["ph"] == "X":
                    ce["dur"] = e["dur"] * 1e6
                else:
                    ce["s"] = "t"              # instant scope: thread
                out.append(ce)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> int:
        trace = self.to_chrome()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])
