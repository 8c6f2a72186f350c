"""``tests/test_torch_sharded_matrix.py`` for zamba2 (Mamba2 layers with
a shared attention block), paligemma (image patches before the text)
and musicgen (codebooks, cross-attention on the conditioning rows): one
step each on (2, 2) gloo ranks against the one-process step."""

import jax
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from test_torch_sharded_train import assert_same_step, one_process

ARCHS = ("zamba2-1p2b", "paligemma-3b", "musicgen-medium")


@pytest.fixture(scope="module")
def matrix_weights():
    return {a: jax.tree.map(np.asarray, jregistry.init(
        jsmoke(jconfigs.get(a)), 0)) for a in ARCHS}


@pytest.fixture(scope="module")
def matrix(matrix_weights, tmp_path_factory):
    return run_ranks(4, "_torch_rank_fns:train_matrix",
                     tmp_path_factory.mktemp("matrix_other"), matrix_weights)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_on_mesh_2x2_equals_one_process(matrix, matrix_weights, arch):
    want = one_process(arch, matrix_weights, compress_grads=False)
    for got in matrix:
        assert_same_step(got[arch], want)
