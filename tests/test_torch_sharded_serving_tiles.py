"""A rank draws only its tiles of the weights, on (1, 2) gloo ranks of the
CPU (``_torch_serve_rank_fns.tiles12``): ``serve_loop.init_tiles`` gives,
leaf for leaf, the tiles that ``cut_tiles`` cuts from the whole init,
for flat GQA, MoE and MLA; the batcher keeps such tiles as they are and
serves the streams of the whole weights; ``stats()["mesh"]`` reports
the rank's weight bytes."""

import pytest

import _torch_serve_rank_fns as R
from _torch_ranks import run_ranks
from repro_torch.models import params as PP


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, "_torch_serve_rank_fns:tiles12",
                     tmp_path_factory.mktemp("tiles12"))


@pytest.mark.parametrize("name", ["minitron-4b", "phi3p5-moe-42b",
                                  "deepseek-v2-lite-16b"])
def test_init_tiles_equal_the_cut_of_the_whole_init(ranks, name):
    cfg = R.smoke(name)
    whole = sum(t.numel() * t.element_size()
                for t in PP.tree_leaves(R.params_for(cfg)))
    for got in ranks:
        assert got[name]["equal"], name
        assert got[name]["bytes"] < whole, (got[name]["bytes"], whole)


def test_batcher_serves_from_tiles(ranks):
    cfg = R.smoke("minitron-4b")
    want = R.serve(cfg, R.params_for(cfg), R.PROMPTS, R.NEWS)[0]
    for got in ranks:
        assert got["streams_from_tiles"] == want
        assert got["streams_from_whole"] == want
        assert got["param_bytes_per_shard"] == got["minitron-4b"]["bytes"]
