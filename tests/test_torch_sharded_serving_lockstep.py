"""Host decisions of a sharded serve in lockstep, on (1, 2) gloo ranks of
the CPU: rank 1's clock stands still an hour ahead, its requests arrive
late, and one request's deadline passes in the queue; every rank emits the same streams and terminal events and the
run ends
(``_torch_serve_rank_fns.lockstep``).  The CLI's ``--mesh 1x2`` on two
ranks prints the mesh banner on rank 0 (``cli``)."""

import pytest

import _torch_serve_rank_fns as R
from _torch_ranks import run_ranks


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    return run_ranks(2, "_torch_serve_rank_fns:lockstep",
                     tmp_path_factory.mktemp("lockstep"))


def test_skewed_clock_and_late_arrivals_give_the_same_events(skewed):
    r0, r1 = skewed
    assert r0 == r1
    kinds = [k for k, _ in r0["outcomes"]]
    assert kinds.count("RequestExpired") == r0["expired"] == 1, kinds
    assert kinds[3] == "RequestExpired" and r0["retired"] == 5


def test_skewed_streams_equal_one_process(skewed):
    """The retired requests' tokens equal a one-process serve of the
    same requests."""
    cfg = R.smoke("minitron-4b")
    prompts = R.PROMPTS + [list(range(90, 100)), list(range(30, 37))]
    keep = [p for i, p in enumerate(prompts) if i != 3]
    want = R.serve(cfg, R.params_for(cfg), keep, [8] * len(keep))[0]
    got = [toks for k, toks in skewed[0]["outcomes"] if k == "retired"]
    assert got == want


def test_launch_cli_mesh_banner(tmp_path):
    """``--mesh 1x2 --device cpu`` through the CLI on two ranks: rank 0
    prints the banner with the mesh, tp, per-shard pool bytes and the
    collective counts; rank 1 prints nothing."""
    out = run_ranks(2, "_torch_serve_rank_fns:cli", tmp_path)
    assert "mesh: 1x2" in out[0] and "tp=2" in out[0]
    assert "B/shard" in out[0] and "psum" in out[0]
    assert "2 requests" in out[0] and out[1] == ""
