"""The port's training path against the JAX package's on the same
bridged weights (smoke minitron-4b, fp32, CPU): the loss and every
gradient leaf of ``loss_fn``; one AdamW ``update`` on identical numpy
gradients; five train steps' losses and gradient norms; and three JAX
steps carried across with ``opt_state_from_numpy``, then a fourth step
in both.

Tolerances: losses to LOSS_ATOL (readings ~1.5e-6), gradient norms to
GNORM_RTOL (readings ~2e-5: bf16 compression can round one element
differently), gradient leaves to GRAD_RTOL of the leaf's largest
element (readings ~1.5e-6), the update to UPDATE_ATOL (the reference's
float32 arithmetic in another order).  ``grad_accum=2`` is held to the
reference's accumulating step at OPT_CFG, where a step moves each
element by ~lr = 5e-4, well above PARAM_ATOL: a dropped divide shows in
the gradient norm, a lost microbatch in the parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as JR
from repro.train import data as JD, optimizer as JOPT, train_loop as JTL
from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.models import params as PP
from repro_torch.train import data as D, optimizer as OPT, train_loop as TL

torch.set_num_threads(2)

LOSS_ATOL = 1e-4
GNORM_RTOL = 1e-4
GRAD_RTOL = 1e-4
UPDATE_ATOL = 1e-6
PARAM_ATOL = 1e-4          # after several steps of bf16-compressed grads
OPT_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
N_STEPS = 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _hold_tree(ref, mine, atol, rel=False, rtol=0.0):
    """Every leaf of the JAX tree ``ref`` against the port's ``mine``
    (``rel``: ``atol`` is a share of the leaf's largest element)."""
    for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
        a = np.asarray(a)
        b = _get(mine, path).detach().numpy()
        tol = atol * max(np.abs(a).max(), 1e-30) if rel else atol
        np.testing.assert_allclose(b, a, rtol=rtol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke(JC.get("minitron-4b"))
    cfg = smoke_variant(configs.get("minitron-4b"))
    return jcfg, cfg, _np(JR.init(jcfg, 0))


@pytest.fixture(scope="module")
def jax_run(setup):
    """Five reference steps: per step (loss, grad norm) and the state
    after each (numpy)."""
    jcfg, _, w = setup
    step, _, _ = JTL.make_train_step(
        jcfg, JTL.TrainCfg(opt=JOPT.OptCfg(**OPT_CFG)), mesh=None,
        donate=False)
    p = jax.tree.map(jnp.asarray, w)
    o = JOPT.init(p)
    dcfg = JD.DataCfg(global_batch=4, seq_len=32)
    metrics, states = [], []
    for s in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in
                 JD.make_batch(jcfg, dcfg, s).items()}
        p, o, m = step(p, o, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        states.append((_np(p), int(o.step), _np(o.m), _np(o.v)))
    return metrics, states


def _port_batch(cfg, step):
    return {k: torch.from_numpy(v) for k, v in D.make_batch(
        cfg, D.DataCfg(global_batch=4, seq_len=32), step).items()}


def test_loss_and_every_gradient_leaf(setup):
    jcfg, cfg, w = setup
    batch = JD.make_batch(jcfg, JD.DataCfg(global_batch=4, seq_len=32), 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTL.loss_fn(jcfg, p, jb), has_aux=True))(
            jax.tree.map(jnp.asarray, w))
    loss, grads = TL.value_and_grad(cfg, PP.params_from_numpy(w, "cpu"),
                                    {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) < LOSS_ATOL
    _hold_tree(jg, grads, GRAD_RTOL, rel=True)


def test_update_on_identical_gradients(setup):
    """Two AdamW updates (warmup, then clipped) on the same numpy
    gradients: params, moments and step equal the reference's."""
    jcfg, _, w = setup
    rng = np.random.default_rng(3)
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=4, clip_norm=5.0)
    jp = jax.tree.map(jnp.asarray, w)
    jo = JOPT.init(jp)
    p = PP.params_from_numpy(w, "cpu")
    o = OPT.init(p)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 0.3, w)
        jp, jo, jm = JOPT.update(JOPT.OptCfg(**oc),
                                 jax.tree.map(jnp.asarray, g), jo, jp)
        p, o, m = OPT.update(OPT.OptCfg(**oc), PP.params_from_numpy(
            g, "cpu"), o, p)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(o.step) == int(jo.step) == 2
    _hold_tree(jp, p, UPDATE_ATOL)
    _hold_tree(jo.m, o.m, UPDATE_ATOL)
    _hold_tree(jo.v, o.v, UPDATE_ATOL)


def test_five_steps_match(setup, jax_run):
    _, cfg, w = setup
    metrics, states = jax_run
    step = TL.make_train_step(cfg, TL.TrainCfg(opt=OPT.OptCfg(**OPT_CFG)))
    p = PP.params_from_numpy(w, "cpu")
    o = OPT.init(p)
    for s in range(N_STEPS):
        p, o, m = step(p, o, _port_batch(cfg, s))
        loss, gnorm = metrics[s]
        assert abs(float(m["loss"]) - loss) < LOSS_ATOL, s
        assert float(m["grad_norm"]) == pytest.approx(gnorm, rel=GNORM_RTOL)
    _hold_tree(states[-1][0], p, PARAM_ATOL)


def test_grad_accum_matches_jax(setup):
    """One step with ``grad_accum=2`` (two microbatches of 2, fp32 sum,
    divide): loss, gradient norm and parameters equal the reference's
    accumulating step on the same weights and batch."""
    jcfg, cfg, w = setup
    batch = JD.make_batch(jcfg, JD.DataCfg(global_batch=4, seq_len=32), 0)
    jstep, _, _ = JTL.make_train_step(
        jcfg, JTL.TrainCfg(opt=JOPT.OptCfg(**OPT_CFG), grad_accum=2),
        mesh=None, donate=False)
    jp = jax.tree.map(jnp.asarray, w)
    jp, _, jm = jstep(jp, JOPT.init(jp),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    step = TL.make_train_step(cfg, TL.TrainCfg(opt=OPT.OptCfg(**OPT_CFG),
                                               grad_accum=2))
    p = PP.params_from_numpy(w, "cpu")
    p, o, m = step(p, OPT.init(p), {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GNORM_RTOL)
    assert int(o.step) == 1
    _hold_tree(_np(jp), p, PARAM_ATOL)


def test_jax_run_continues_in_the_port(setup, jax_run):
    """The reference's state after three steps, carried across with
    ``params_from_numpy`` and ``opt_state_from_numpy``: the port's fourth
    step gives the reference's fourth loss, norm and parameters."""
    _, cfg, _ = setup
    metrics, states = jax_run
    jp, jstep, jm, jv = states[2]
    p = PP.params_from_numpy(jp, "cpu")
    o = PP.opt_state_from_numpy(jstep, jm, jv, "cpu")
    assert int(o.step) == 3 and o.m["embed"].dtype == torch.float32
    assert np.array_equal(o.v["embed"].numpy(), jv["embed"])
    step = TL.make_train_step(cfg, TL.TrainCfg(opt=OPT.OptCfg(**OPT_CFG)))
    p, o, m = step(p, o, _port_batch(cfg, 3))
    assert abs(float(m["loss"]) - metrics[3][0]) < LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(metrics[3][1],
                                                  rel=GNORM_RTOL)
    assert int(o.step) == states[3][1] == 4
    _hold_tree(states[3][0], p, PARAM_ATOL)


def test_vocab_padding_masked_in_loss():
    """Padded vocab columns take no probability mass (the reference's
    ``test_vocab_padding_masked_in_loss``), equal to the JAX loss."""
    cfg = smoke_variant(configs.get("minitron-4b"))
    assert cfg.padded_vocab > cfg.vocab_size
    logits = torch.zeros((2, 4, cfg.padded_vocab))
    labels = torch.zeros((2, 4), dtype=torch.int32)
    loss = TL.cross_entropy(cfg, logits, labels)
    np.testing.assert_allclose(float(loss), np.log(cfg.vocab_size),
                               rtol=1e-5)
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((2, 4, cfg.padded_vocab)).astype(np.float32)
    lb = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    ref = JTL.cross_entropy(jsmoke(JC.get("minitron-4b")), jnp.asarray(lg),
                            jnp.asarray(lb))
    mine = TL.cross_entropy(cfg, torch.from_numpy(lg), torch.from_numpy(lb))
    assert abs(float(mine) - float(ref)) < 1e-6
