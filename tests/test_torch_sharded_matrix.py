"""The families the sharded-training tests do not hold, each one step on
(2, 2) gloo ranks of the CPU (one 4-rank launch for the module) against
the port's one-process step from the same JAX-initialised smoke weights,
at the tolerances of ``tests/test_torch_sharded_train.py``: gemma3's
local/global layers, granite (one K/V head: K/V replicated beside the
query heads), qwen (qkv bias) and deepseek's MLA.  zamba2, paligemma
and musicgen: ``tests/test_torch_sharded_matrix_other.py``."""

import jax
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from test_torch_sharded_train import assert_same_step, one_process

ARCHS = ("gemma3-12b", "granite-34b", "qwen1p5-32b", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def matrix_weights():
    return {a: jax.tree.map(np.asarray, jregistry.init(
        jsmoke(jconfigs.get(a)), 0)) for a in ARCHS}


@pytest.fixture(scope="module")
def matrix(matrix_weights, tmp_path_factory):
    return run_ranks(4, "_torch_rank_fns:train_matrix",
                     tmp_path_factory.mktemp("matrix"), matrix_weights)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_mesh_2x2_equals_one_process(matrix, matrix_weights, arch):
    want = one_process(arch, matrix_weights, compress_grads=False)
    for got in matrix:
        assert_same_step(got[arch], want)
