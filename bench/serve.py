"""The serving cells: an offline backlog through the port's
``ContinuousBatcher`` (``submit`` -> ``run``), measured from the
client's side.

Every response stream is a ``Client``: the batcher's ``Push`` of a token
is stamped on the host clock where the client receives it, with no
thread of the harness's own in the loop.  The window is driven from the
batcher's own loop: the harness hands it a heartbeat (the hook a
supervisor uses), whose ``beat`` at the top of every iteration opens the
window, notes the batcher's step and chunk counters, starts and stops
the profiled sub-window of a traced run, and ends the run by raising
``WindowClosed``.  The batcher then ends its in-flight requests with
typed events, which the harness ignores: they come after the close.

Everything is queued before the run; the window opens once every
request that starts in flight has its first token (the ramp, counted in
set-up) and the run ends at the close.  The port's own telemetry stays
off in every run: the per-layer readings come from the beats' counters
and the clients' stamps (``metrics/spans.py``), which cost the loop a
list append per iteration and per token.
"""

from __future__ import annotations

import bisect
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import harness
from .device import Profile

CLOCK = time.perf_counter


class WindowClosed(Exception):
    """Raised from the batcher's heartbeat to end the run."""


def _client_cls():
    from repro_torch.core.stream import Stream

    class Client(Stream):
        """A response stream that keeps each token and its arrival time
        and nothing in a queue."""

        def __init__(self, rid: int, on_first: Callable[[], None]):
            super().__init__(depth=1, name=f"client{rid}")
            self.t: List[float] = []
            self.tok: List[int] = []
            self.fail = None
            self.fail_at: Optional[float] = None
            self.closed_at: Optional[float] = None
            self._on_first = on_first

        def Push(self, value, timeout=None):
            now = CLOCK()
            if isinstance(value, (int, np.integer)):
                if not self.t:
                    self._on_first()
                self.t.append(now)
                self.tok.append(int(value))
            else:       # a typed event: keep its kind, not its cause
                self.fail = getattr(value, "kind", "failed")
                self.fail_at = now

        def close(self):
            if self.closed_at is None:
                self.closed_at = CLOCK()
            super().close()
    return Client


class Window:
    """The run's phases, read at each iteration of the batcher's loop.
    From the window's opening, each beat notes (time, decode steps,
    prefill chunks) of the batcher ``counters`` reads."""

    def __init__(self, seconds: float, trace: bool,
                 ready: Callable[[], bool], counters: Callable[[], tuple],
                 profile_s: float):
        self.seconds = seconds
        self.ready, self.counters = ready, counters
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self.beats: List[tuple] = []
        self.prof = Profile(CLOCK) if trace else None
        self.profile_s = profile_s
        self.p_start: Optional[float] = None

    def beat(self, _worker: str) -> None:
        now = CLOCK()
        if self.t0 is None:
            if self.ready():
                self.t0 = now
                self.t1 = now + self.seconds
                self.p_start = now + 0.4 * self.seconds
                self.beats.append((now,) + self.counters())
            return
        self.beats.append((now,) + self.counters())
        if self.prof is not None:
            # starting and stopping the profiler take a beat of their own
            # that runs no step: a pseudo-iteration the readers skip
            if (not self.prof.active and self.prof.t0 is None
                    and now >= self.p_start):
                self.prof.start()
                self.beats.append((CLOCK(),) + self.counters())
            elif self.prof.active and (now >= self.prof.t0 + self.profile_s
                                       or now >= self.t1):
                self.prof.stop()
                self.beats.append((CLOCK(),) + self.counters())
        if now >= self.t1:
            self.stopped_at = now
            raise WindowClosed()


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        cfg=None, t_start: float = 0.0, log=None) -> Dict[str, Any]:
    """One run of a serving cell: its end-to-end metrics, what the
    judge needs (the weights, the finished requests, their prompts) and,
    traced, the per-layer readers' context."""
    from repro_torch.serve.batching import ContinuousBatcher, Request
    from . import weights as W
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cfg = cfg or harness.port_config(cell.config)
    sv = cell.serving
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats()
    params = W.draw(cfg, seed, device, dtype=getattr(torch, cfg.dtype))
    specs = harness.generator(cell)(cell.traffic["params"], seed,
                                    vocab=cfg.vocab_size,
                                    slots=int(sv["n_slots"]))
    n_first = [0]

    def on_first():
        n_first[0] += 1
    Client = _client_cls()
    clients = {r["rid"]: Client(r["rid"], on_first) for r in specs}
    bat = ContinuousBatcher(
        cfg, params, n_slots=int(sv["n_slots"]), max_seq=int(sv["max_seq"]),
        n_pages=sv.get("n_pages"), page_size=int(sv["page_size"]),
        prefill_chunk=int(sv["prefill_chunk"]),
        prefill_interleave=int(sv.get("prefill_interleave", 1)),
        queue_depth=len(specs) + 1, clock=CLOCK, device=device)
    n_init = sum(1 for r in specs if r["initial"])
    win = Window(seconds, trace and device.type == "cuda",
                 lambda: n_first[0] >= n_init,
                 lambda: (bat.steps, bat.prefill_chunks),
                 profile_s=min(3.0, 0.3 * seconds))
    bat._heartbeat = win
    for r in specs:
        bat.submit(Request(rid=r["rid"], prompt=r["prompt"],
                           max_new=r["max_new"], out=clients[r["rid"]]))
    try:
        bat.run(10 ** 12)
    except WindowClosed:
        pass
    bat.requests.close()
    t0, t1, t_stop = win.t0, win.t1, win.stopped_at
    if t0 is None or t_stop is None:
        raise RuntimeError("the window never opened or never closed")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    metrics, attempted, failed = client_metrics(clients, t0, t1, t_stop,
                                                seconds)
    metrics["setup_s"] = t0 - t_start
    toks = round(metrics["serve_tokens_per_s"] * seconds)
    log(f"window {t0 - t_start:.3f}..{t1 - t_start:.3f} s, stopped at "
        f"{t_stop - t_start:.3f}; tokens in window {toks}, "
        f"attempted {attempted}, failed {failed}; batcher {bat.steps} "
        f"steps, {bat.prefill_chunks} chunks, {bat.preemptions} preemptions")

    ctx = None
    if trace:
        prompt_len = {r["rid"]: len(r["prompt"]) for r in specs}
        ctx = {"iterations": iterations(win.beats, clients, prompt_len),
               "t0": t0, "t1": t1, "config": cell.config, "serving": sv,
               "seconds": seconds,
               "profile": win.prof.summary() if win.prof else None,
               "p0": win.prof.t0 if win.prof else None,
               "p1": win.prof.t1 if win.prof else None}

    finished = {i: c for i, c in clients.items()
                if c.closed_at is not None and c.fail is None and c.tok
                and c.closed_at <= t_stop}
    del bat
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"metrics": metrics, "attempted": attempted, "failed": failed,
            "peak": peak, "ctx": ctx, "params": params, "cfg": cfg,
            "finished": finished, "specs": {r["rid"]: r for r in specs},
            "window": (t0, t1, t_stop)}


def iterations(beats: List[tuple], clients, prompt_len: Dict[int, int]
               ) -> List[Dict[str, Any]]:
    """The batcher's iterations between consecutive beats of the window:
    each one's start, duration, the decode steps and prefill chunks it
    ran, the positions its tokens were decoded at (a request's token
    ``j`` > 0 at ``prompt_len + j - 1``) and the prompt lengths whose
    first token it produced."""
    times = [b[0] for b in beats]
    its = [{"ts": a[0], "dur": b[0] - a[0], "steps": b[1] - a[1],
            "chunks": b[2] - a[2], "positions": [], "firsts": []}
           for a, b in zip(beats, beats[1:])]
    for rid, c in clients.items():
        for j, t in enumerate(c.t):
            k = bisect.bisect_right(times, t) - 1
            if 0 <= k < len(its):
                if j == 0:
                    its[k]["firsts"].append(prompt_len[rid])
                else:
                    its[k]["positions"].append(prompt_len[rid] + j - 1)
    return its


def client_metrics(clients, t0: float, t1: float, t_stop: float,
                   seconds: float):
    """Tokens the clients received in [t0, t1] over the window's
    seconds; attempted, the requests with a token in the window or in
    flight across it, failed, those of them ended by an error before
    the stop.  Returns (metrics, attempted, failed)."""
    toks = sum(1 for c in clients.values() for t in c.t if t0 <= t <= t1)
    live = [c for c in clients.values()
            if c.t and c.t[0] <= t1 and (c.closed_at is None
                                         or c.closed_at >= t0)]
    failed = sum(1 for c in live if c.fail is not None
                 and c.fail_at < t_stop)
    return {"serve_tokens_per_s": toks / seconds}, len(live), failed


def sample(finished: Dict[int, Any], seed: int, k: int) -> List[int]:
    """The rids to judge: the finished request with the most served
    tokens, and k - 1 more drawn from the seed."""
    if not finished:
        return []
    ids = sorted(finished)
    longest = max(ids, key=lambda i: (len(finished[i].tok), -i))
    rest = [i for i in ids if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)),
                           replace=False)) if rest else []
    return [longest] + sorted(int(i) for i in pick)


def judge(out: Dict[str, Any], cell: harness.Cell, seed: int, device,
          lowp: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """The sample against the float32 reference: ``gap``, the widest gap
    by which a token's reference logit lies below the reference's best,
    and ``mismatch_share``, the tokens that are not its best.  Returns
    {"program": ...} for the served tokens and, with ``lowp``, also
    {"control": ...} for the token the control puts first at the same
    positions."""
    from .reference.model import Reference, served_gaps
    ref = Reference(cell.config, out["params"], device)
    ctl = Reference(cell.config, out["params"], device, lowp) if lowp \
        else None
    k = int(cell.traffic.get("check", {}).get("requests", 6))
    ids = sample(out["finished"], seed, k)
    sides = ("program", "control") if ctl is not None else ("program",)
    acc = {s: {"gap": 0.0, "mismatches": 0} for s in sides}
    n = 0
    with torch.no_grad():
        for i in ids:
            g = served_gaps(ref, out["specs"][i]["prompt"],
                            out["finished"][i].tok, ctl)
            n += g["tokens"]
            for s in sides:
                acc[s]["gap"] = max(acc[s]["gap"], g[s]["gap"])
                acc[s]["mismatches"] += g[s]["mismatches"]
    n = max(n, 1)
    return {s: {"gap": a["gap"], "mismatch_share": a["mismatches"] / n,
                "requests": len(ids), "tokens_judged": n}
            for s, a in acc.items()}
