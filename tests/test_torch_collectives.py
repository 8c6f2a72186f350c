"""Multi-rank collectives, the GPipe schedule and sharded buffers of the
port on 8 gloo ranks of the CPU (mirror of ``tests/test_distributed.py``'s
collective and pipeline cases): the rank bodies live in
``_torch_rank_fns.py`` and run once for the module; each test holds one
part of their results, against ``dist.all_reduce``, sequential
composition, or the reference's own sequential gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro_torch.core import pipeline as TPL

WORLD = 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(WORLD, "_torch_rank_fns:rank_work_8",
                     tmp_path_factory.mktemp("collectives"))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("schedule", ["tree", "ring", "lat"])
def test_all_reduce_schedules_equal_dist_all_reduce(ranks, schedule, op):
    """Tree, ring and the per-tensor switch equal ``dist.all_reduce``
    exactly on integer-valued fp32, on every rank."""
    for r in ranks:
        c = r["collectives"]
        np.testing.assert_array_equal(c[f"{schedule}_{op}"], c[f"want_{op}"])


def test_ring_collectives_roundtrip(ranks):
    """``tests/test_distributed.py::test_ring_collectives_roundtrip``:
    rank r ends the reduce-scatter with the sum of column r; the
    all-gather stacks the ranks' values in rank order."""
    table = np.arange(WORLD * 8, dtype=np.float32).reshape(WORLD, 8)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["collectives"]["rs"],
                                      table.sum(0)[r:r + 1])
        np.testing.assert_array_equal(res["collectives"]["ag"],
                                      np.arange(WORLD, dtype=np.float32
                                                )[:, None])


def test_collectives_over_a_mesh_axis_and_ppermute_grad(ranks):
    """A tree all-reduce over the "data" axis of a (4, 2) mesh sums the
    four ranks of each model column; ``ppermute``'s gradient takes the
    reverse hop (rank r receives r - 1's value; its input's gradient is
    what rank r + 1 scaled it by)."""
    for r, res in enumerate(ranks):
        c = res["collectives"]
        col = [d * 2 + r % 2 for d in range(4)]
        np.testing.assert_array_equal(c["mesh_tree"], np.full(3, sum(col)))
        np.testing.assert_array_equal(c["hop"], np.full(4, (r - 1) % WORLD))
        np.testing.assert_array_equal(c["hop_grad"],
                                      np.full(4, (r + 1) % WORLD + 1.0))


def test_gpipe_pipeline_matches_composition(ranks):
    """``tests/test_distributed.py::test_gpipe_pipeline_matches_composition``
    on each of the two 4-stage pipelines, every rank holding the outputs."""
    import torch
    xs = torch.arange(24., dtype=torch.float32).reshape(6, 4)
    ref = TPL.fused_pipeline([lambda x, i=i: x * (i + 1.0)
                              for i in range(4)], xs).numpy()
    for res in ranks:
        np.testing.assert_array_equal(res["gpipe"]["ys"], ref)
    assert abs(TPL.pipeline_efficiency(6, 4) - 6 / 9) < 1e-9


def test_gpipe_train_grads_match_reference(ranks):
    """``tests/test_distributed.py::test_gpipe_train_grads_match_sequential``:
    the loss through the GPipe schedule equals the reference's sequential
    loss to 1e-6, its gradients the reference's ``jax.value_and_grad``."""
    params = jnp.asarray([[1.0], [0.5], [2.0], [1.5]])
    xs = jnp.arange(24., dtype=jnp.float32).reshape(6, 4) / 10.0
    tgt = jnp.ones((6, 4))

    def seq_loss(params):
        def step(_, x):
            for i in range(4):
                x = jnp.tanh(x * params[i, 0])
            return None, x
        _, ys = jax.lax.scan(step, None, xs)
        return jnp.mean((ys - tgt) ** 2)

    loss_s, grads_s = jax.value_and_grad(seq_loss)(params)
    for res in ranks:
        g = res["gpipe"]
        assert abs(g["loss"] - float(loss_s)) < 1e-6, (g["loss"], loss_s)
        np.testing.assert_allclose(g["grads"], np.asarray(grads_s),
                                   rtol=1e-5, atol=1e-6)


def test_memory_bank_sharded_places_and_gathers(ranks):
    """``MemoryBank.sharded("data")`` on a context over an 8-rank mesh:
    rank r holds rows 2r, 2r+1; ``CopyToHost`` gathers the buffer back
    bit for bit; ``CopyFromHost`` keeps the placement; ``bank0`` is
    replicated."""
    data = np.arange(WORLD * 2 * 3, dtype=np.float32).reshape(WORLD * 2, 3)
    for r, res in enumerate(ranks):
        b = res["bank"]
        assert b["placements"] == b["placements2"] == "(Shard(dim=0),)"
        np.testing.assert_array_equal(b["local"], data[2 * r:2 * r + 2])
        np.testing.assert_array_equal(b["host"], data)
        np.testing.assert_array_equal(b["local2"], 2 * data[2 * r:2 * r + 2])
        np.testing.assert_array_equal(b["rep_local"], data)
