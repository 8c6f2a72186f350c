"""Mean number of live slots a decode step of the window ran: the
tokens its clients received in each iteration that ran one decode step
(the batcher's step counter) and no prefill chunk, outside the profiled
sub-window."""
from bench.metrics.spans import decode_steps


def read(ctx):
    ss = decode_steps(ctx)
    return sum(len(s["positions"]) for s in ss) / len(ss) if ss else None
