"""Kernel B1's share of its roofline in the profiled sub-window: the
least time of the decode steps' paged attention (``bench.counts.
b1_step_bound_s`` from each step's live positions) over the card's time
in B1's kernels (``flash_decode_paged_kernel`` and its combine)."""
from bench import counts
from bench.metrics.spans import decode_steps

NAMES = ("flash_decode_paged_kernel", "flash_decode_paged_combine")


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    t = sum(s for n, s in prof["by_name"].items()
            if any(k in n for k in NAMES))
    if t <= 0:
        return None
    sv = ctx["serving"]
    page = int(sv["page_size"])
    bound = sum(counts.b1_step_bound_s(
        ctx["config"], s["positions"], page, int(sv["n_slots"]),
        -(-int(sv["max_seq"]) // page))
        for s in decode_steps(ctx, inside=True))
    return 100.0 * bound / t if bound else None
