"""Sharded training of the port on gloo ranks of the CPU (mirror of
``tests/test_distributed.py``'s sharded-step and elastic cases): the
train step on a ``DeviceMesh`` of DTensors equals the port's one-process
step and the JAX package's one-device step on bridged weights.  Two
launches serve the module: minitron on (4, 2) (8 ranks; it also saves
the checkpoint of the elastic case) and the elastic restart on the 4
surviving ranks.  ZeRO-1, bf16 reduction, microbatches and the moe and
ssm families on (2, 2): ``tests/test_torch_sharded_families.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.train import data as JD, optimizer as JOPT, train_loop as JTL
from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.models import params as PP
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (checkpoint as CK, data as D, optimizer as OPT,
                               train_loop as TL)

ARCHS = ("minitron-4b", "phi3p5-moe-42b", "mamba2-1p3b")
# the reference test's tolerance (tests/test_distributed.py)
LOSS_TOL, P_RTOL, P_ATOL = 1e-4, 2e-3, 2e-5
# each first-moment element to this share of its leaf's largest (the
# GRAD_RTOL of tests/test_torch_train_families.py)
M_RTOL = 1e-4


def _np(tree):
    return tree_map(lambda _, t: t.detach().cpu().numpy(), tree)


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v) for k, v in D.make_batch(
        cfg, D.DataCfg(global_batch=8, seq_len=16), step).items()}


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised smoke weights of each arch, as numpy."""
    return {a: jax.tree.map(np.asarray, jregistry.init(
        jsmoke(jconfigs.get(a)), 0)) for a in ARCHS}


def one_process(arch, weights, **tc):
    cfg = smoke_variant(configs.get(arch))
    params = PP.params_from_numpy(weights[arch], "cpu")
    p, o, m = TL.make_train_step(cfg, TL.TrainCfg(**tc))(
        params, OPT.init(params), _batch(cfg))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _np(p), "m": _np(o.m), "v": _np(o.v)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def mesh42(weights, ckpt, tmp_path_factory):
    return run_ranks(8, "_torch_rank_fns:train_mesh42",
                     tmp_path_factory.mktemp("mesh42"), weights, ckpt)


def assert_same_step(got, want, moments=True):
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        np.testing.assert_allclose(a, b, rtol=P_RTOL, atol=P_ATOL)
    if moments:   # every gradient element, through the first moment
        assert_moments(got["m"], want["m"])


def assert_moments(got, want):
    """Each element to M_RTOL of its leaf's largest (the reduction orders
    of the mesh and of one process differ)."""
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=M_RTOL * np.abs(b).max())


def test_sharded_step_4x2_equals_one_process(mesh42, weights):
    """``tests/test_distributed.py::test_sharded_train_step_matches_single_device``
    on the port: every rank ends with the one-process step's loss and
    parameters; the parameters carry their ``param_specs``."""
    want = one_process("minitron-4b", weights, compress_grads=False)
    for got in mesh42:
        assert_same_step(got, want)
    specs = mesh42[0]["param_specs"]
    assert specs["blocks"]["attn"]["wq"] == (None, None, "model")
    assert specs["blocks"]["mlp"]["w_down"] == (None, "model", None)
    assert mesh42[0]["param_placements"]["blocks"]["attn"]["wq"] == \
        "(Replicate(), Shard(dim=2))"


def test_batch_that_does_not_split_over_data_is_refused(mesh42):
    """A global batch of 6 on (4, 2) is refused with a ``ValueError``
    before the step runs (the reference's batch sharding needs the rows
    to split over (pod, data) too); indivisible parameter dims are left
    unsharded instead (``tests/test_torch_sharding_rules.py``, granite's
    one K/V head in ``tests/test_torch_sharded_matrix.py``)."""
    for got in mesh42:
        assert got["batch6"] and "do not split" in got["batch6"]


def test_sharded_step_4x2_equals_jax_one_device(mesh42, weights):
    """The same sharded step against the JAX package's one-device step on
    the same (bridged) weights and batch."""
    jcfg = jsmoke(jconfigs.get("minitron-4b"))
    step, _, _ = JTL.make_train_step(jcfg, JTL.TrainCfg(compress_grads=False),
                                     mesh=None, donate=False)
    jp = jax.tree.map(jnp.asarray, weights["minitron-4b"])
    batch = {k: jnp.asarray(v) for k, v in JD.make_batch(
        jcfg, JD.DataCfg(global_batch=8, seq_len=16), 0).items()}
    p1, _, m1 = step(jp, JOPT.init(jp), batch)
    want = {"loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
            "params": jax.tree.map(np.asarray, p1)}
    assert_same_step(mesh42[0], want, moments=False)


def test_elastic_remesh_resumes(mesh42, ckpt, tmp_path):
    """``tests/test_distributed.py::test_elastic_remesh_resumes``: the
    (4, 2) run's checkpoint, restored on the 4 ranks that survive (a
    (2, 2) ``elastic_mesh``; moments through ``restore(shardings=)``,
    parameters through ``reshard_state``), takes a finite step equal to
    the one-process step from the same checkpoint."""
    got = run_ranks(4, "_torch_rank_fns:train_elastic", tmp_path, ckpt)
    cfg = smoke_variant(configs.get("minitron-4b"))
    like = PP.init_params(TL.registry.decls(cfg), 0, device="cpu")
    state, step, _ = CK.restore(ckpt, {"params": like,
                                       "opt": OPT.init(like)})
    p, o, m = TL.make_train_step(cfg, TL.TrainCfg(compress_grads=False))(
        state["params"], state["opt"], _batch(cfg, step))
    want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _np(p)}
    for g in got:
        assert g["mesh"] == {"data": 2, "model": 2} and g["step"] == 1
        assert np.isfinite(g["loss"])
        assert_same_step(g, want, moments=False)
