"""The host tier of a sharded serve (ROADMAP C7), on (1, 2) gloo ranks of
the CPU (``_torch_mesh_rank_fns.tier_shards``): a prompt is demoted to
T1 by a filler and served again from it, with bf16 and int8 pages.
Each rank copies and keeps only its own tiles, so its transfer bytes and
the bytes its T1 store holds are half the one-process serve's, while the
tier counters, which count entries at full width, equal the
one-process serve's on every rank, and so do the streams.  The (1, 2)
snapshot that restores on one process and on (1, 4) is
``test_torch_sharded_serving_wide.py``'s."""

import pytest

import _torch_mesh_rank_fns as M
from _torch_ranks import run_ranks

KVS = ("bfloat16", "int8")
# the engine's byte counters: what this rank copied, a tp-th of the whole.
PER_RANK = ("d2h_bytes", "h2d_bytes")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, "_torch_mesh_rank_fns:tier_shards",
                     tmp_path_factory.mktemp("tiers"))


@pytest.fixture(scope="module")
def one_process():
    return {kv: M.tier_serve(*M.tier_case(kv_cache_dtype=kv)) for kv in KVS}


@pytest.mark.parametrize("kv", KVS)
def test_each_rank_copies_and_holds_half(ranks, one_process, kv):
    whole = one_process[kv]
    assert whole["tiers"]["demotions"] >= 1 and whole["tiers"]["rehits"] >= 1
    assert whole["held"] > 0
    for got in ranks:
        g = got[kv]
        for key in PER_RANK:
            assert g["tiers"][key] * 2 == whole["tiers"][key], key
        assert g["held"] * 2 == whole["held"]
        # the store counts full width: the budget binds the whole serve.
        assert g["tiers"]["t1_bytes"] == whole["tiers"]["t1_bytes"] \
            == whole["held"]


@pytest.mark.parametrize("kv", KVS)
def test_tier_stats_equal_on_every_rank_and_one_process(ranks, one_process,
                                                        kv):
    def policy(t):
        return {k: v for k, v in t.items() if k not in PER_RANK}
    want = policy(one_process[kv]["tiers"])
    for got in ranks:
        assert policy(got[kv]["tiers"]) == want


@pytest.mark.parametrize("kv", KVS)
def test_streams_equal_one_process(ranks, one_process, kv):
    want = one_process[kv]["streams"]
    assert want[2] == want[0]                 # the rehit is the cold run
    for got in ranks:
        assert got[kv]["streams"] == want
