"""Sharded serving on wider meshes, on gloo ranks of the CPU: minitron on
(1, 4), (2, 2) and (4,) streams the one-process tokens; a T2 snapshot
written on (1, 2) (``_torch_serve_rank_fns.snapshot12``, 2 ranks)
restores to the cold stream on one process and on (1, 4)
(``mesh4``, 4 ranks); and after ``psum_parts`` and ``gather_parts``
every rank of a 4-rank group holds the same bits."""

import numpy as np
import pytest

import _torch_serve_rank_fns as R
from _torch_ranks import run_ranks
from repro_torch.serve.batching import ContinuousBatcher


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wide")
    snap = str(tmp / "kv_tier.snap")
    written = run_ranks(2, "_torch_serve_rank_fns:snapshot12", tmp, snap)
    return snap, written, run_ranks(4, "_torch_serve_rank_fns:mesh4", tmp,
                                    snap)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4,)])
def test_sharded_identity_wider_meshes(launches, shape):
    """tp 4, a (2, 2) data x model mesh and a rank-1 pure-TP mesh all
    reproduce the one-process stream on every rank; the pools split
    over the model axis only."""
    cfg = R.smoke("minitron-4b")
    want = R.serve(cfg, R.params_for(cfg), R.PROMPTS, R.NEWS)[0]
    tp = shape[-1]
    for got in launches[2]:
        g = got[shape]
        assert g["streams"] == want, (shape, want, g["streams"])
        m = g["mesh"]
        assert m["shape"] == shape and m["tp"] == tp
        assert m["pool_bytes_per_shard"] * tp == m["pool_bytes_total"]


def test_snapshot_from_1x2_restores_on_one_process_and_1x4(launches):
    """The (1, 2) snapshot holds full-width payloads: a one-process
    batcher and a (1, 4) one both load it and serve the prompt from T1
    with only the catch-up chunk, streaming the cold run's tokens."""
    snap, written, wide = launches
    cold = written[0]["streams"]
    assert all(w == written[0] for w in written)
    assert written[0]["demotions"] >= 3
    tcfg = R.tier_cfg(R.smoke("minitron-4b"), snap)
    bat = ContinuousBatcher(tcfg, R.params_for(tcfg), n_slots=2, max_seq=64,
                            device="cpu")
    assert bat._tiers.stats()["snapshot_loaded"] >= 3
    assert R.serve_seq(bat, [R.shared_prompt(tcfg)], [5]) == cold
    assert bat._tiers.stats()["rehits"] >= 1 and bat.prefill_chunks == 1
    for got in wide:
        r = got["restored"]
        assert r["streams"] == cold and r["loaded"] >= 3
        assert r["rehits"] >= 1 and r["chunks"] == 1


def test_collectives_leave_the_same_bits_on_every_rank(launches):
    """``psum_parts`` and ``gather_parts`` on rank-dependent fp32 and
    bf16 inputs: every rank of the 4-rank group holds the same bytes,
    and the sum is the group-rank-order fp32 sum."""
    bits = [got["bits"] for got in launches[2]]
    for key in bits[0]:
        for b in bits[1:]:
            assert np.array_equal(b[key], bits[0][key]), key
    import torch
    xs = []
    for rank in range(4):
        gen = torch.Generator().manual_seed(100 + rank)
        xs.append(torch.randn(64, 96, generator=gen) * 10 ** torch.randint(
            -3, 4, (64, 96), generator=gen).float())
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    got = np.frombuffer(bits[0]["psum torch.float32"].tobytes(),
                        np.float32).reshape(64, 96)
    assert np.array_equal(got, acc.numpy())
