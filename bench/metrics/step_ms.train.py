"""Median host time of the window's train steps outside the profiled
ones, each ending in a read of its loss."""
import statistics


def read(ctx):
    steps = [s for s in ctx.get("steps") or () if not s["profiled"]]
    if not steps:
        return None
    return statistics.median(s["end"] - s["start"] for s in steps) * 1e3
