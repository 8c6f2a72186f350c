"""The per-layer readers on a synthetic run (the harness's beats and
the clients' stamps, and a profile), and the end-to-end number from
client stamps, with a stall inside the window that has to move them."""

import pytest

from bench import counts, harness, serve

CFG = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
       "vocab_size": 1000, "mlp_gated": False}
SERVING = {"n_slots": 4, "max_seq": 64, "page_size": 8, "prefill_chunk": 16}


class Stamped:
    def __init__(self, t, fail=None, fail_at=None, closed_at=None):
        self.t, self.fail, self.fail_at = list(t), fail, fail_at
        self.closed_at = closed_at


def run(stall=0.0):
    """Window [1.0, 2.0]: one iteration of 0.04 s prefills request 1
    (prompt 20), then 9 decode iterations of 0.1 s (the 5th stalled by
    ``stall``), each giving a token to requests 0 (prompt 30, 11 tokens
    already) and 1.  Returns (clients, beats)."""
    beats = [(1.0, 0, 0), (1.04, 0, 1)]
    t, steps = 1.04, 0
    ends = []
    for k in range(9):
        t += 0.1 + (stall if k == 4 else 0.0)
        steps += 1
        beats.append((t, steps, 1))
        ends.append(t - 0.001)
    clients = {0: Stamped([0.5 - 0.01 * (11 - j) for j in range(11)]
                          + ends),
               1: Stamped([1.039] + ends)}
    return clients, beats


def ctx_of(clients, beats, p0=None, p1=None):
    its = serve.iterations(beats, clients, {0: 30, 1: 20})
    return {"iterations": its, "t0": 1.0, "t1": 2.0, "config": CFG,
            "serving": SERVING, "seconds": 1.0, "p0": p0, "p1": p1,
            "profile": {"busy_s": 0.25, "window_s": 1.0,
                        "by_name": {"flash_decode_paged_kernel<x>": 0.002,
                                    "flash_decode_paged_combine": 0.0005,
                                    "gemm": 0.1}}}


def read(name, ctx):
    return harness.reader(name)(ctx)


def positions(k):
    """The positions decode iteration k decoded at: request 0's token
    11 + k at 30 + 10 + k, request 1's token 1 + k at 20 + k."""
    return sorted([40 + k, 20 + k])


def test_iterations_from_beats_and_stamps():
    its = ctx_of(*run())["iterations"]
    assert [(i["steps"], i["chunks"]) for i in its] == \
        [(0, 1)] + [(1, 0)] * 9
    assert its[0]["firsts"] == [20] and its[0]["positions"] == []
    assert [sorted(i["positions"]) for i in its[1:]] == \
        [positions(k) for k in range(9)]


def test_span_readers():
    ctx = ctx_of(*run())
    assert read("decode_batch_mean.decode", ctx) == 2
    assert read("decode_step_ms.decode", ctx) == pytest.approx(100.0)
    assert read("device_idle_share.decode", ctx) == pytest.approx(75.0)


def test_mfu_counts_every_token_once():
    ctx = ctx_of(*run())
    want = sum(counts.decode_step_flops(CFG, positions(k))
               for k in range(9)) + counts.prefill_chunk_flops(CFG, 0, 16) \
        + counts.prefill_chunk_flops(CFG, 16, 4)
    got = read("step_mfu.serve", ctx)
    # over the iterations' host time: 0.04 s of prefill, 0.9 of decode
    assert got == pytest.approx(100 * want / 0.94 / counts.PEAK_BF16_FLOPS)


def test_b1_share_from_live_positions():
    ctx = ctx_of(*run(), p0=1.0, p1=2.0)
    bound = sum(counts.b1_step_bound_s(CFG, positions(k), 8, 4, 8)
                for k in range(9))
    assert read("b1_roofline_share.decode", ctx) == pytest.approx(
        100 * bound / 0.0025)


def test_host_readers_skip_the_profiled_sub_window():
    """Decode iterations 2 and 3 profiled and slowed: the host
    readers leave them out, B1's share reads only them."""
    clients, beats = run(stall=0.0)
    beats = [(t + (0.5 if t > 1.3 else 0.0), *c) for t, *c in beats]
    clients = {r: Stamped([t + (0.5 if t > 1.3 else 0.0) for t in c.t])
               for r, c in clients.items()}
    # the sub-window from the start of decode iteration 2 to the end of 3
    ctx = ctx_of(clients, beats, p0=beats[3][0], p1=beats[5][0])
    assert read("decode_step_ms.decode", ctx) == pytest.approx(100.0)
    bound = sum(counts.b1_step_bound_s(CFG, positions(k), 8, 4, 8)
                for k in (2, 3))
    assert read("b1_roofline_share.decode", ctx) == pytest.approx(
        100 * bound / 0.0025)
    secs = 0.04 + 0.1 * 7
    want = sum(counts.decode_step_flops(CFG, positions(k))
               for k in range(9) if k not in (2, 3)) \
        + counts.prefill_chunk_flops(CFG, 0, 16) \
        + counts.prefill_chunk_flops(CFG, 16, 4)
    assert read("step_mfu.serve", ctx) == pytest.approx(
        100 * want / secs / counts.PEAK_BF16_FLOPS)


def test_readers_find_nothing_to_read():
    ctx = ctx_of(*run())
    ctx["iterations"] = []
    ctx["profile"] = None
    for m in ("decode_batch_mean.decode", "decode_step_ms.decode",
              "step_mfu.serve", "b1_roofline_share.decode",
              "device_idle_share.decode"):
        assert read(m, ctx) is None, m


def test_a_stall_moves_the_step_and_the_rate():
    base = ctx_of(*run())
    hit = ctx_of(*run(stall=0.3))
    assert read("decode_step_ms.decode", hit) > read(
        "decode_step_ms.decode", base) + 30
    m0, att, failed = serve.client_metrics(run()[0], 1.0, 2.0, 2.0, 1.0)
    m1, _, _ = serve.client_metrics(run(stall=0.3)[0], 1.0, 2.0, 2.0, 1.0)
    assert att == 2 and failed == 0
    assert m0["serve_tokens_per_s"] == 19
    assert m1["serve_tokens_per_s"] < m0["serve_tokens_per_s"]
