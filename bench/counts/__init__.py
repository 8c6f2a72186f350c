"""Frozen FLOP and byte formulas: the yardstick of ``step_mfu.*`` and
of B1's roofline share.  They are written from the published model
equations and kept here, apart from the program, so that a change to
the program cannot move its own yardstick.  ``bench/test_bench_counts.py``
ties them to the program's own counter at smoke width on the CPU.

Convention (PaLM's model FLOPs): every weight matrix a token passes
through counts 2 FLOPs per weight once, whatever the program recomputes
or pads; attention counts 4·hq·head_dim per (query, key) pair the
causal mask keeps; the output head counts 2·d·V for each row whose
logits are produced.  A MoE layer counts the experts each token is
routed to (top_k) and the shared experts, not the rows a
capacity-bounded dispatch happens to compute.
"""

from __future__ import annotations

from typing import Dict

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_weights(c: Dict) -> Dict[str, int]:
    """Weights a token passes through in one layer, by the configuration
    file's keys: {"attn", "mlp"}."""
    d, hq = c["hidden_size"], c["num_attention_heads"]
    hd, hkv = c["head_dim"], c["num_key_value_heads"]
    gated = 3 if c.get("mlp_gated", True) else 2
    return {"attn": d * hq * hd + 2 * d * hkv * hd + hq * hd * d,
            "mlp": gated * d * c["intermediate_size"]}


def active_weights(c: Dict) -> int:
    """Weights one token passes through below the output head."""
    w = layer_weights(c)
    return c["num_hidden_layers"] * (w["attn"] + w["mlp"])


def attention_flops(c: Dict, pairs: float) -> float:
    """Score and value products over ``pairs`` (query, key) pairs, all
    layers."""
    return 4.0 * c["num_attention_heads"] * c["head_dim"] * pairs \
        * c["num_hidden_layers"]


def causal_pairs(start: int, n: int) -> int:
    """(query, key) pairs of ``n`` queries at positions start..start+n-1
    attending causally to every key at or before them."""
    return n * start + n * (n + 1) // 2


def forward_flops(c: Dict, tokens: int, pairs: float, logit_rows: int
                  ) -> float:
    """Model FLOPs of a forward over ``tokens`` tokens, ``pairs``
    attention pairs, and logits for ``logit_rows`` rows."""
    return (2.0 * active_weights(c) * tokens + attention_flops(c, pairs)
            + 2.0 * c["hidden_size"] * c["vocab_size"] * logit_rows)


def decode_step_flops(c: Dict, positions) -> float:
    """One decode step: one token per live slot at its position (it
    attends to pos + 1 keys) and one logit row each."""
    n = len(positions)
    return forward_flops(c, n, sum(int(p) + 1 for p in positions), n)


def prefill_chunk_flops(c: Dict, base: int, n: int) -> float:
    """A prefill chunk of ``n`` prompt tokens at positions base..: one
    logit row (the last token's)."""
    return forward_flops(c, n, causal_pairs(base, n), 1)


def train_step_flops(c: Dict, batch: int, seq: int) -> float:
    """Forward and backward (3x the forward) of a train step over
    ``batch`` rows of ``seq`` tokens, logits at every position; no
    recomputation counted."""
    return 3.0 * forward_flops(c, batch * seq, batch * causal_pairs(0, seq),
                               batch * seq)


def b1_step_bound_s(c: Dict, positions, page: int, slots: int,
                    table_width: int, kv_bytes: int = 2,
                    peak_flops: float = PEAK_BF16_FLOPS,
                    hbm: float = HBM_BYTES_PER_S) -> float:
    """Least time of kernel B1 (paged GQA decode attention) over one
    decode step of ``slots`` rows, every layer: per layer each live page
    of K and V read once (a slot at ``pos`` has ``ceil((pos + 1) /
    page)``; ``positions`` lists the live slots'), q read and the output
    written once for every row, the block table (``table_width`` entries
    a row) and the positions read once; operations 4·hq·d per live key
    row.  The larger of bytes over the HBM rate and operations over the
    bf16 peak, as ``chip_smoke.bound_ms`` takes it per call."""
    hq, hkv, d = c["num_attention_heads"], c["num_key_value_heads"], \
        c["head_dim"]
    live = sum(-(-(int(p) + 1) // page) for p in positions)
    per_page = hkv * page * d * kv_bytes * 2
    nbytes = live * per_page + 2 * slots * hq * d * 2 \
        + slots * table_width * 4 + slots * 4
    ops = 4.0 * hq * d * live * page
    per_layer = max(nbytes / hbm, ops / peak_flops)
    return per_layer * c["num_hidden_layers"]
