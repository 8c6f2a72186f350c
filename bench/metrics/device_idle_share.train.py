"""Share of the profiled sub-window in which no kernel or copy ran on
the card: 1 - (union of their intervals) / (sub-window's host time)."""
from bench.metrics.spans import idle_share


def read(ctx):
    return idle_share(ctx)
