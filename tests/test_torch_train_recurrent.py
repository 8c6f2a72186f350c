"""One train step of mamba2 and zamba2 against the JAX package (the
tolerances and the method of ``tests/test_torch_train_families.py``),
and ``use_pallas`` refused on both: it routes the SSD scan through
kernel B6, which has no backward (the reference's Pallas scan cannot be
differentiated either)."""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.train import train_loop as TL
from test_torch_train_families import one_step_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["mamba2-1p3b", "zamba2-1p2b"])
def test_one_train_step_matches_jax(arch):
    one_step_matches_jax(arch)


@pytest.mark.parametrize("arch", ["mamba2-1p3b", "zamba2-1p2b"])
def test_use_pallas_is_refused(arch):
    cfg = dataclasses.replace(smoke_variant(configs.get(arch)),
                              use_pallas=True)
    with pytest.raises(NotImplementedError, match="B6"):
        TL.make_train_step(cfg)
