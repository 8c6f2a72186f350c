"""Shared liveness/health primitives (port of ``core/health.py``: the
reference's module imports no JAX, and the port keeps its own copy).

* ``Heartbeat``         — per-worker liveness with a miss threshold.
* ``StragglerDetector`` — per-step EWMA/variance z-score; flags workers
  (or a whole step pipeline) running slower than the fleet.

Everything here watches wall-clock timing only — no device, no hardware
counters — so the failure paths are fully simulable in CPU tests.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence


class Heartbeat:
    """Liveness registry.  Workers call ``beat(worker)``; the monitor
    thread marks workers dead after ``timeout`` seconds of silence.

    ``clock`` is injectable (defaults to wall time) so supervisors
    under a fake clock get deterministic stall detection."""

    def __init__(self, workers: Sequence[str], timeout: float = 10.0,
                 clock: Optional[Callable[[], float]] = None):
        self.timeout = timeout
        self.clock = clock or time.monotonic
        self._last: Dict[str, float] = {w: self.clock() for w in workers}
        self._lock = threading.Lock()

    def beat(self, worker: str) -> None:
        with self._lock:
            self._last[worker] = self.clock()

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else self.clock()
        with self._lock:
            return [w for w, t in self._last.items()
                    if now - t > self.timeout]

    def alive(self) -> List[str]:
        d = set(self.dead())
        with self._lock:
            return [w for w in self._last if w not in d]


class StragglerDetector:
    """EWMA step-time tracker.  ``observe`` returns True when the new
    sample is a straggler (> mean + z·std, with warmup grace)."""

    def __init__(self, alpha: float = 0.2, z: float = 3.0, warmup: int = 5,
                 min_dt: float = 0.05):
        self.alpha, self.z, self.warmup = alpha, z, warmup
        self.min_dt = min_dt      # ignore sub-jitter steps (CPU smoke runs)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            self.mean = dt
            return False
        is_straggler = (self.n > self.warmup
                        and dt > self.min_dt
                        and dt > self.mean + self.z * math.sqrt(self.var)
                        and dt > 1.5 * self.mean)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler
