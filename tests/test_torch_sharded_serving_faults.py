"""A fault on one rank of a sharded serve, on (1, 2) gloo ranks of the
CPU (``_torch_serve_rank_fns.lone_fault``): rank 1 cannot follow rank 0
(its requests carry other ids, or none reach it within its follow
timeout).  Rank 1 raises ``LockstepError``, which the batcher's loop
does not swallow, its ``fail_inflight`` enters no collective, and rank 0
ends too when rank 1 leaves the group, well before the group's timeout.
Every request either rank took gets a terminal event."""

import json

import pytest

from _torch_ranks import PG_TIMEOUT, run_ranks_ending


def _outcomes(stderr):
    line = [x for x in stderr.splitlines() if x.startswith("OUTCOMES ")]
    assert len(line) == 1, stderr[-4000:]
    return json.loads(line[0][len("OUTCOMES "):])


@pytest.mark.parametrize("how,why", [("other", "where rank 0 took"),
                                     ("late", "which rank 0 took")])
def test_one_rank_fails_alone_and_both_end(tmp_path, how, why):
    ranks, took = run_ranks_ending(2, "_torch_serve_rank_fns:lone_fault",
                                   tmp_path, how)
    (rc0, err0), (rc1, err1) = ranks
    assert took < PG_TIMEOUT.total_seconds(), (took, err0[-4000:])
    assert rc1 != 0 and "LockstepError" in err1 and why in err1, err1[-4000:]
    one = _outcomes(err1)
    assert one["error"] == "LockstepError"
    # rank 1's own requests ("other": all three, the one it popped
    # among them) are cancelled, none left waiting.
    assert one["outcomes"] == (["RequestCancelled"] * 3 if how == "other"
                               else []), one
    # rank 0 loses its peer in a collective and ends with an error; what
    # it took is errored, what it had not, cancelled.
    zero = _outcomes(err0)
    assert rc0 != 0 and zero["error"] != "NoneType", err0[-4000:]
    assert zero["error"] != "LockstepError" or "reached no peer" in err0
    assert len(zero["outcomes"]) == 3 and "hang" not in zero["outcomes"]
    assert "retired" not in zero["outcomes"], zero
