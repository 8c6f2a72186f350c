"""Mean host time of the window's decode iterations outside the
profiled sub-window: from one beat of the batcher's loop to the next,
over each iteration that ran one decode step and no prefill chunk (the
step, its read of the tokens and their hand-off to the clients)."""
from bench.metrics.spans import decode_steps


def read(ctx):
    ss = decode_steps(ctx)
    return sum(s["dur"] for s in ss) / len(ss) * 1e3 if ss else None
