"""Readings of a serving run's iterations shared by the metric files.

The profiled sub-window [``p0``, ``p1``] runs slower (the profiler's own
start and stop, and its record of every kernel): the host-side readings
take the iterations outside it, the device-side ones those inside."""

from __future__ import annotations

from typing import Dict, List


def profiled(ctx, it: Dict) -> bool:
    """Whether iteration ``it`` overlaps the profiled sub-window."""
    p0, p1 = ctx.get("p0"), ctx.get("p1")
    return p0 is not None and it["ts"] < p1 and it["ts"] + it["dur"] > p0


def unprofiled(ctx) -> List[Dict]:
    """The window's iterations outside the profiled sub-window."""
    return [it for it in ctx["iterations"] if not profiled(ctx, it)]


def decode_steps(ctx, inside: bool = False) -> List[Dict]:
    """Iterations that ran one decode step and no prefill chunk: those
    outside the profiled sub-window, or with ``inside`` those wholly in
    it."""
    its = ctx["iterations"]
    if inside:
        its = [it for it in its if it["ts"] >= ctx["p0"]
               and it["ts"] + it["dur"] <= ctx["p1"]]
    else:
        its = [it for it in its if not profiled(ctx, it)]
    return [it for it in its if it["steps"] == 1 and it["chunks"] == 0]


def idle_share(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
