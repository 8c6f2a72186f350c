"""Model FLOPs of every token decoded and of every prompt whose first
token came in the window's iterations outside the profiled sub-window
(the frozen formulas of ``bench.counts``: weights once per token, causal
attention pairs, a logit row per decoded token and per prompt; a prompt
in chunks of ``prefill_chunk``), over those iterations' host time at
the bf16 peak of one H100."""
from bench import counts
from bench.metrics.spans import unprofiled


def read(ctx):
    c = ctx["config"]
    chunk = int(ctx["serving"]["prefill_chunk"])
    flops, secs = 0.0, 0.0
    for it in unprofiled(ctx):
        secs += it["dur"]
        if it["positions"]:
            flops += counts.decode_step_flops(c, it["positions"])
        for plen in it["firsts"]:
            for base in range(0, plen, chunk):
                flops += counts.prefill_chunk_flops(
                    c, base, min(chunk, plen - base))
    if not flops:
        return None
    return 100.0 * flops / (secs * counts.PEAK_BF16_FLOPS)
