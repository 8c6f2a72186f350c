"""One train step for the attention families against the JAX package,
mirroring ``tests/test_models.py::test_smoke_one_train_step`` (the
recurrent families are in ``tests/test_torch_train_recurrent.py``):
smoke width, fp32,
the reference's weights bridged with ``params_from_numpy`` and its
batch (``registry.make_batch``, bf16 patches / cond bridged bit for
bit).  Loss to LOSS_ATOL and gradient norm to GNORM_RTOL of the JAX
step's (readings: loss <= 4e-6, norm <= 3e-5; bf16 compression can
round one element differently); the step count advances and the
parameters move.  Every gradient element is held through the first
moment after the step, m = (1 - beta1) * clip(g), which both packages
keep: to GRAD_RTOL of its leaf's largest element plus one bf16 ulp of
itself, at most 2**-7 of it (``compress_grads`` may round it the other
way; without compression the readings are <= 2e-6 of the leaf's
largest element).  A gradient of
the wrong sign or in the wrong place inside a leaf the global norm
barely sees (router, MLA latent projections, cross-attention) fails
there.  The parameters are not held elementwise: Adam's first step
moves an element by ~lr * sign(g), so an element whose gradient sits at
its leaf's float32 noise floor (zamba2's ``w_out``: -4.3e-8 in JAX,
+4.0e-7 here, leaf max 0.85) moves the other way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as JR
from repro.train import optimizer as JOPT, train_loop as JTL
from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.models import params as PP
from repro_torch.train import optimizer as OPT, train_loop as TL
from test_torch_train_parity import _hold_tree

torch.set_num_threads(2)

LOSS_ATOL = 1e-4
GNORM_RTOL = 1e-4
GRAD_RTOL = 1e-4
BF16_ULP = 2.0 ** -7


def one_step_matches_jax(arch):
    jcfg = jsmoke(JC.get(arch))
    cfg = smoke_variant(configs.get(arch))
    w = jax.tree.map(np.asarray, JR.init(jcfg, 0))
    jbatch = JR.make_batch(jcfg, "train", 2, 32)
    oc = dict(warmup_steps=1, total_steps=10)
    step, _, _ = JTL.make_train_step(
        jcfg, JTL.TrainCfg(opt=JOPT.OptCfg(**oc)), mesh=None, donate=False)
    jp = jax.tree.map(jnp.asarray, w)
    _, jo, jm = step(jp, JOPT.init(jp), jbatch)

    params = PP.params_from_numpy(w, "cpu")
    before = [p.clone() for p in OPT.sorted_leaves(params)]
    batch = PP.params_from_numpy(jax.tree.map(np.asarray, jbatch), "cpu")
    tstep = TL.make_train_step(cfg, TL.TrainCfg(opt=OPT.OptCfg(**oc)))
    params, o, m = tstep(params, OPT.init(params), batch)
    assert np.isfinite(float(m["loss"]))
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_ATOL
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=GNORM_RTOL)
    assert int(o.step) == int(jo.step) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(before, OPT.sorted_leaves(params)))
    _hold_tree(jax.tree.map(np.asarray, jo.m), o.m, GRAD_RTOL, rel=True,
               rtol=BF16_ULP)


@pytest.mark.parametrize("arch", [
    "gemma3-12b", "phi3p5-moe-42b", "deepseek-v2-lite-16b", "paligemma-3b",
    "musicgen-medium"])
def test_one_train_step_matches_jax(arch):
    one_step_matches_jax(arch)
