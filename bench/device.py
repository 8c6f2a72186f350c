"""The device side of a run: its identity, its peak memory, and a
profiled sub-window of the traced run (``torch.profiler`` over CUDA
activity only): busy time as the union of the card's kernel and copy
intervals, kernels by name, and the longest idle gaps.  The arithmetic
is ``chip_smoke.profile_window``'s, kept here as the benchmark's own."""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import torch


def identity(count: int = 1) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count)}


class Profile:
    """Starts and stops ``torch.profiler`` at host clock readings; each
    call must come when the device has finished the work launched so far
    (the serving loop's iterations end in a device-to-host read)."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.prof = None
        self.t0 = self.t1 = None
        # (name, start, end) in seconds, of every kernel and copy
        self.kernels: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = self.clock()

    def stop(self) -> None:
        """Stops recording; the events are read later, in ``summary``,
        so the run pays no reading inside its window."""
        torch.cuda.synchronize()
        self.t1 = self.clock()
        self.prof.stop()
        self._done, self.prof = self.prof, None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def summary(self) -> Optional[Dict]:
        """busy_s, window_s and the breakdown, or None if nothing ran on
        the device."""
        done = getattr(self, "_done", None)
        if done is not None:
            from torch.autograd import DeviceType
            for ev in done.events():
                if ev.device_type == DeviceType.CUDA:
                    tr = ev.time_range
                    self.kernels.append((ev.name, tr.start / 1e6,
                                         tr.end / 1e6))
            self._done = None
        if not self.kernels or self.t1 is None:
            return None
        iv = sorted((s, e) for _, s, e in self.kernels)
        busy, gaps = 0.0, []
        cs, ce = iv[0]
        nxt = sorted(self.kernels, key=lambda k: k[1])
        for (s, e), k in zip(iv[1:], nxt[1:]):
            if s > ce:
                busy += ce - cs
                gaps.append((s - ce, k[0]))
                cs, ce = s, e
            else:
                ce = max(ce, e)
        busy += ce - cs
        by_name = collections.defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gap_by = collections.defaultdict(float)
        for g, name in gaps:
            gap_by["launching " + name[:120]] += g
        return {"busy_s": busy, "window_s": self.t1 - self.t0,
                "device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": sorted(([n, s] for n, s in gap_by.items()),
                                    key=lambda kv: -kv[1])[:10],
                "by_name": dict(by_name)}
