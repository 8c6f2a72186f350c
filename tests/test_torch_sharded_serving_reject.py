"""Shedding at a full queue on a sharded serve (ROADMAP A13d), on (1, 2)
gloo ranks of the CPU (``_torch_mesh_rank_fns.shed``): rank 0 decides
each ``TryPush`` and every rank follows, so with rank 1's producer late
both ranks shed the same requests with the same typed ``queue_full``
rejection, retire the same ones, and stream what a one-process serve of
the admitted requests streams."""

import pytest

import _torch_mesh_rank_fns as M
import _torch_serve_rank_fns as R
from _torch_ranks import run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, "_torch_mesh_rank_fns:shed",
                     tmp_path_factory.mktemp("shed"))


def test_every_rank_sheds_and_retires_alike(ranks):
    r0, r1 = ranks
    assert r0 == r1
    assert r0["answers"][:4] == [True, True, False, False]
    kinds = [k for k, _ in r0["outcomes"]]
    shed = kinds.count("RequestRejected")
    assert r0["rejections"] == {"queue_full": shed} and shed >= 2
    assert r0["retired"] == kinds.count("retired") == len(kinds) - shed
    assert [not a for a in r0["answers"]] == [
        k == "RequestRejected" for k in kinds]
    assert all("queue_full" in why for k, why in r0["outcomes"]
               if k == "RequestRejected")


def test_streams_equal_one_process_with_the_same_shed_set(ranks):
    cfg = R.smoke("minitron-4b")
    kept = [p for p, a in zip(M.SHED_PROMPTS, ranks[0]["answers"]) if a]
    want = R.serve(cfg, R.params_for(cfg), kept, [M.SHED_NEW] * len(kept),
                   n_slots=1)[0]
    got = [toks for k, toks in ranks[0]["outcomes"] if k == "retired"]
    assert got == want
