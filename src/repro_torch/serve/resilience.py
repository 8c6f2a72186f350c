"""Resilient serving (port of ``serve/resilience.py``): SLA lifecycle
vocabulary, deterministic fault injection, and a supervising wrapper
around the continuous batcher.

The module is host Python throughout; the port keeps it line for line,
so a ``FaultPlan`` spec and seed fire on the same call ordinals as the
reference's (the per-site ``np.random.default_rng`` streams are seeded
the same way).  The supervisor's telemetry events come with the
telemetry slice.

The hlslib argument is that hardware-style pipelines earn their keep
only with software-engineering discipline: failure modes must be
*simulable* — exercised in CI on a laptop — before the design meets
real traffic.  This module packages that discipline for the serving
engine (``serve.batching``):

* **Typed request lifecycle** — every request ends in exactly one
  terminal outcome: ``retired`` (stream closes after the last token),
  or a ``TerminalEvent`` pushed *in-band* into ``Request.out`` before
  the close (``rejected`` / ``expired`` / ``errored`` / ``cancelled``).
  ``drain()`` re-raises the event as a typed ``RequestFailed`` subclass
  carrying the partial tokens and the original cause — a consumer can
  never hang on a request the batcher gave up on.

* **SLA classes** — ``Request.klass`` ∈ {latency, standard, batch} maps
  onto the batcher's preemption priorities (``CLASS_RANK``); with
  ``schedule="sla"`` admission orders by class then deadline, sheds
  batch-class work whose deadline the projected queue delay already
  blows, and the step loop cancels expired requests, freeing their
  pages immediately.

* **``FaultPlan``** — seeded, deterministic fault injection.  A spec
  like ``"step:3;t1_d2h:1+;alloc:2..5;snapshot_corrupt:1"`` names a
  *site* and the call ordinals at which it fires; sites are checked by
  the batcher's step wrappers (``step`` / ``chunk`` / ``verify``), the staged
  transfer engine (``t1_d2h`` / ``t1_h2d``), the page allocator
  (``alloc``), and the T2 snapshot writer (``snapshot_corrupt`` /
  ``snapshot_truncate``).  The same spec + seed always fires at the
  same points, so every degradation path is a reproducible CI case.

* **``ServeSupervisor``** — watchdogs the batcher run loop with the
  shared ``Heartbeat`` (``core.health``).
  On a fatal step fault it journals the in-flight requests, has the
  batcher rebuild its device pools, and resubmits the journal as
  recompute-mode records: greedy decode is deterministic, so replayed
  requests re-emit with output pushes suppressed and every surviving
  token stream is bit-identical to a fault-free run.  The degradation
  ladder below the supervisor lives in the batcher itself: transfer
  retries with capped backoff -> recompute fallback -> tier-off after
  repeated T1 faults.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.health import Heartbeat

# SLA class -> scheduling/preemption rank (higher = served first,
# preempted last).  Unknown classes rank as "standard".
CLASS_RANK: Dict[str, int] = {"batch": 0, "standard": 1, "latency": 2}


def class_rank(klass: str) -> int:
    return CLASS_RANK.get(klass, 1)


# --- typed terminal outcomes -----------------------------------------------------------


class RequestFailed(RuntimeError):
    """Base of every typed terminal failure ``drain()`` raises.

    ``tokens`` holds whatever the consumer had already received — a
    failure after N streamed tokens is not a total loss, and tests use
    it to check the partial prefix is still exact."""

    def __init__(self, rid: int, reason: str, tokens: Sequence[int] = ()):
        super().__init__(f"request {rid}: {reason}")
        self.rid = rid
        self.reason = reason
        self.tokens = list(tokens)


class RequestRejected(RequestFailed):
    """Admission refused the request (queue full, unservable geometry,
    or batch-class load shedding against its deadline)."""


class RequestExpired(RequestFailed):
    """The request's ``deadline_ms`` passed before completion; any
    in-flight pages were freed immediately."""


class RequestErrored(RequestFailed):
    """A step/chunk fault killed the request; ``__cause__`` carries the
    original exception."""


class RequestCancelled(RequestFailed):
    """The batcher shut down (fatal fault / teardown) with the request
    still queued or pending."""


_EVENT_ERRORS = {
    "rejected": RequestRejected,
    "expired": RequestExpired,
    "errored": RequestErrored,
    "cancelled": RequestCancelled,
}


@dataclasses.dataclass
class TerminalEvent:
    """In-band terminal marker pushed into ``Request.out`` before the
    stream closes.  ``drain()`` converts it to the matching
    ``RequestFailed`` subclass (chaining ``cause``)."""

    kind: str                    # "rejected" | "expired" | "errored" | "cancelled"
    rid: int
    reason: str = ""
    cause: Optional[BaseException] = None

    @classmethod
    def rejected(cls, rid: int, reason: str) -> "TerminalEvent":
        return cls("rejected", rid, reason)

    @classmethod
    def expired(cls, rid: int, reason: str) -> "TerminalEvent":
        return cls("expired", rid, reason)

    @classmethod
    def errored(cls, rid: int, cause: BaseException) -> "TerminalEvent":
        return cls("errored", rid, f"{type(cause).__name__}: {cause}",
                   cause=cause)

    @classmethod
    def cancelled(cls, rid: int, reason: str) -> "TerminalEvent":
        return cls("cancelled", rid, reason)

    def to_error(self, tokens: Sequence[int] = ()) -> RequestFailed:
        err = _EVENT_ERRORS[self.kind](self.rid, self.reason, tokens)
        err.__cause__ = self.cause
        return err


# --- deterministic fault injection -----------------------------------------------------


class InjectedFault(RuntimeError):
    """Raised by ``FaultPlan.check`` at a firing site."""

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at site '{site}' (call #{call})")
        self.site = site
        self.call = call


@dataclasses.dataclass
class _Rule:
    first: int                   # 1-based call ordinal
    last: float                  # inclusive; inf for open-ended
    prob: float = 1.0


def _site_seed(site: str, seed: int) -> int:
    # stable across processes (str hash is randomized; sha1 is not)
    return seed ^ int.from_bytes(
        hashlib.sha1(site.encode()).digest()[:4], "little")


class FaultPlan:
    """Seeded, deterministic fault schedule.

    Spec grammar (``;``-separated clauses)::

        site:N        fire on exactly the Nth call to the site
        site:N+       fire on every call from the Nth on
        site:N..M     fire on calls N through M inclusive
        site:*        fire on every call
        ...@P         any of the above, each matching call fires with
                      probability P (seeded per-site RNG — deterministic
                      for a given seed)

    ``fire(site)`` advances the site's call counter and reports whether
    this call faults; ``check(site)`` raises ``InjectedFault`` instead.
    An empty spec never fires and costs one dict lookup per check, so
    the hooks stay in the production path permanently — exactly the
    hlslib stance that the simulation harness IS the product."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec or ""
        self.seed = int(seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._rng: Dict[str, np.random.Generator] = {}
        self.fired: Dict[str, List[int]] = {}
        for clause in filter(None, (c.strip()
                                    for c in self.spec.split(";"))):
            if ":" not in clause:
                raise ValueError(f"fault clause '{clause}': want site:when")
            site, when = clause.split(":", 1)
            prob = 1.0
            if "@" in when:
                when, p = when.split("@", 1)
                prob = float(p)
            if when == "*":
                rule = _Rule(1, float("inf"), prob)
            elif when.endswith("+"):
                rule = _Rule(int(when[:-1]), float("inf"), prob)
            elif ".." in when:
                a, b = when.split("..", 1)
                rule = _Rule(int(a), float(int(b)), prob)
            else:
                rule = _Rule(int(when), float(int(when)), prob)
            self._rules.setdefault(site, []).append(rule)

    @classmethod
    def resolve(cls, explicit: Any = None, cfg_spec: str = "") -> "FaultPlan":
        """Precedence: an explicit plan/spec wins, then the
        ``REPRO_FAULTS`` env var, then the config knob.  Seed comes from
        ``REPRO_FAULT_SEED`` unless an explicit plan carries its own."""
        if isinstance(explicit, FaultPlan):
            return explicit
        spec = explicit if explicit is not None else os.environ.get(
            "REPRO_FAULTS", cfg_spec or "")
        seed = int(os.environ.get("REPRO_FAULT_SEED", "0"))
        return cls(str(spec or ""), seed=seed)

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def fire(self, site: str) -> bool:
        rules = self._rules.get(site)
        if not rules:
            return False
        n = self._calls[site] = self._calls.get(site, 0) + 1
        for rule in rules:
            if not rule.first <= n <= rule.last:
                continue
            if rule.prob < 1.0:
                rng = self._rng.get(site)
                if rng is None:
                    rng = self._rng[site] = np.random.default_rng(
                        _site_seed(site, self.seed))
                if rng.random() >= rule.prob:
                    continue
            self.fired.setdefault(site, []).append(n)
            return True
        return False

    def check(self, site: str) -> None:
        if self.fire(site):
            raise InjectedFault(site, self._calls[site])


# --- batcher-level faults --------------------------------------------------------------


class BatcherFault(RuntimeError):
    """A fatal fault in the batcher run loop (step exception or watchdog
    stall).  Carries the original ``cause``; the supervisor decides
    between journaled recovery and erroring the in-flight requests."""

    def __init__(self, cause: BaseException):
        super().__init__(f"fatal batcher fault: "
                         f"{type(cause).__name__}: {cause}")
        self.cause = cause


class StallFault(RuntimeError):
    """Watchdog verdict: the run loop missed its heartbeat window."""


# --- the serving supervisor ------------------------------------------------------------


@dataclasses.dataclass
class ServeReport:
    faults: int = 0              # fatal BatcherFaults observed
    restarts: int = 0            # journal + rebuild + resubmit cycles
    recovered_requests: int = 0  # journaled records resubmitted
    stalls: int = 0              # watchdog heartbeat misses


class ServeSupervisor:
    """Watchdog + restart policy around ``ContinuousBatcher.run``.

    The batcher beats the shared ``Heartbeat`` once per loop iteration;
    a monitor thread flags a stall (``batcher._stalled``) when the beat
    goes silent past ``heartbeat_timeout``, which the loop converts to
    a ``BatcherFault`` at its next opportunity.  On any fatal fault the
    supervisor journals the in-flight requests, rebuilds the device
    pools, resubmits the journal (recompute-mode replay — surviving
    outputs bit-identical to a fault-free run), and re-enters the loop;
    after ``max_restarts`` recoveries it errors everything still in
    flight (typed events, so no consumer hangs) and re-raises."""

    def __init__(self, batcher, *, max_restarts: int = 2,
                 heartbeat_timeout: float = 30.0, clock=None):
        self.batcher = batcher
        self.max_restarts = max_restarts
        # The watchdog's clock stays wall time unless injected: a
        # fake-clocked BATCHER under a real supervisor must not trip
        # the stall detector just because its fake clock never
        # advances between beats (or advances by hours).  Telemetry
        # tests that want deterministic stall timing inject one here.
        self._clock = clock or time.monotonic
        self.heartbeat = Heartbeat(["batcher"], timeout=heartbeat_timeout,
                                   clock=self._clock)
        self.report = ServeReport()
        batcher._heartbeat = self.heartbeat
        batcher._supervised = True

    def _watch(self, stop: threading.Event) -> None:
        while not stop.wait(min(self.heartbeat.timeout / 4, 1.0)):
            if self.heartbeat.dead():
                self.report.stalls += 1
                self.batcher._stalled = True

    def run(self, total_requests: int, **kw) -> ServeReport:
        stop = threading.Event()
        watchdog = threading.Thread(target=self._watch, args=(stop,),
                                    daemon=True)
        watchdog.start()
        try:
            while True:
                try:
                    self.batcher.run(total_requests, **kw)
                    return self.report
                except BatcherFault as e:
                    self.report.faults += 1
                    if (self.report.restarts >= self.max_restarts
                            or not self.batcher.paged):
                        # out of recovery budget (or the dense path,
                        # which has no journaled replay): error every
                        # in-flight consumer with the original cause so
                        # nobody waits out a drain() timeout.
                        self.batcher.fail_inflight(e.cause)
                        raise
                    self.heartbeat.beat("batcher")   # recovery takes time
                    self.report.recovered_requests += self.batcher.recover()
                    self.report.restarts += 1
        finally:
            stop.set()
            # the watchdog wakes at least once a second; the bound keeps
            # a wedged monitor from hanging the caller.
            watchdog.join(timeout=5.0)
