"""Sharded training on (2, 2) gloo ranks of the CPU, one 4-rank launch
for the module (``_torch_rank_fns.train_mesh22``): minitron with ZeRO-1,
with bf16 gradient reduction and with two microbatches; phi3.5-moe and
mamba2 — each step against the port's one-process step from the same
(JAX-initialised) weights, at the tolerances of
``tests/test_torch_sharded_train.py``."""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro_torch.models import params as PP
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import optimizer as OPT
from test_torch_sharded_train import (assert_moments, assert_same_step,
                                      one_process, weights)  # noqa: F401


@pytest.fixture(scope="module")
def mesh22(weights, tmp_path_factory):
    return run_ranks(4, "_torch_rank_fns:train_mesh22",
                     tmp_path_factory.mktemp("mesh22"), weights)


def test_zero1_2x2_equals_one_process(mesh22, weights):
    """ZeRO-1 on (2, 2): each data rank keeps its slice of the moments
    (sharded over "data" as well) and the step still equals the
    one-process step, moments included."""
    want = one_process("minitron-4b", weights, compress_grads=False)
    for got in mesh22:
        z = got["zero1"]
        assert_same_step(z, want)
        assert_moments(z["v"], want["v"])
        assert any("Shard" in p.split(",")[0] for p in z["m_placements"])


@pytest.mark.parametrize("case,tc", [
    ("compress", dict(compress_grads=True)),
    ("accum", dict(compress_grads=False, grad_accum=2))])
def test_compressed_and_accumulated_2x2_equal_one_process(mesh22, weights,
                                                         case, tc):
    """bf16 gradient reduction (the data-axis reduction in bf16) and two
    microbatches on (2, 2) against the one-process step."""
    want = one_process("minitron-4b", weights, **tc)
    for got in mesh22:
        assert_same_step(got[case], want, moments=case == "accum")


@pytest.mark.parametrize("arch", ["phi3p5-moe-42b", "mamba2-1p3b"])
def test_families_on_mesh_2x2_equal_one_process(mesh22, weights, arch):
    """phi3.5-moe (experts over "model", the dispatch over all tokens)
    and mamba2 (d_inner and the SSM heads over "model") on (2, 2)."""
    want = one_process(arch, weights, compress_grads=False)
    for got in mesh22:
        assert_same_step(got[arch], want)


def test_zero1_update_equals_one_process_update(mesh22, weights):
    """``optimizer.update`` with ZeRO-1 moments (each data rank's slice,
    then the all-gather) equals the one-process ``update`` to 1e-6 on
    the same seeded gradients and moments."""
    plain = PP.params_from_numpy(weights["minitron-4b"], "cpu")
    gen = torch.Generator().manual_seed(5)

    def draw(scale):
        return tree_map(lambda _, p: torch.randn(p.shape, generator=gen)
                        * scale, plain)
    grads, m = draw(1e-2), draw(1e-3)
    v = tree_map(lambda _, t: t.abs(), draw(1e-3))
    state = OPT.OptState(torch.tensor(3, dtype=torch.int32), m, v)
    p2, o2, met = OPT.update(OPT.OptCfg(warmup_steps=2, total_steps=10),
                             grads, state, plain)
    for got in mesh22:
        u = got["update"]
        assert any("Shard" in p for p in u["m_placements"])
        np.testing.assert_allclose(u["grad_norm"], float(met["grad_norm"]),
                                   rtol=1e-6)
        for name, want in (("params", p2), ("m", o2.m), ("v", o2.v)):
            for a, b in zip(tree_leaves(u[name]), tree_leaves(want)):
                np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-6)
