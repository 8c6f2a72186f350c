"""Model FLOPs of the window's train steps outside the profiled ones
(``bench.counts.train_step_flops``: forward and backward, no
recomputation) over those steps' host time at the bf16 peak of one
H100."""
from bench import counts


def read(ctx):
    steps = [s for s in ctx.get("steps") or () if not s["profiled"]]
    if not steps:
        return None
    f = sum(counts.train_step_flops(ctx["config"], s["batch"], s["seq"])
            for s in steps)
    secs = sum(s["end"] - s["start"] for s in steps)
    return 100.0 * f / (secs * counts.PEAK_BF16_FLOPS)
