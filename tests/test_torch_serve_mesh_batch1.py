"""The dense-cache serve steps on a ``DeviceMesh`` at batch 1 (ROADMAP
A13c), on (2, 2) gloo ranks of the CPU
(``_torch_mesh_rank_fns.serve_steps_batch1``): the reference's
long-context layout, where each attention cache's sequence splits over
"data" (``seq_sharded``): GQA, gemma3's global layers (its windowed
local ones stay whole), MLA's latent rows and zamba2's shared block,
while the recurrent state splits over its heads.  On the JAX package's
seed-0 parameters carried across, every family with a dense cache gives
the JAX package's ``greedy_generate`` tokens and the port's meshless
greedy tokens, and every rank the same first-step logits."""

import numpy as np
import pytest

import _torch_mesh_rank_fns as M
from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch.models import params as PP

STEPS, MAX_SEQ = 4, 32


@pytest.fixture(scope="module")
def gold():
    """{arch: (the JAX package's seed-0 parameters as numpy, its greedy
    tokens of the batch-1 prompt)}."""
    out = {}
    for arch in M.BATCH1_ARCHS:
        jcfg = jsmoke(jconfigs.get(arch))
        jp = jregistry.init(jcfg, 0)
        prompt = M.batch1_prompt(jcfg).astype(np.int32)
        want = np.asarray(jgreedy(jcfg, jp, {"tokens": prompt},
                                  steps=STEPS, max_seq=MAX_SEQ))
        out[arch] = (PP.tree_map(lambda _, a: np.asarray(a), jp), want)
    return out


@pytest.fixture(scope="module")
def batch1(gold, tmp_path_factory):
    return run_ranks(4, "_torch_mesh_rank_fns:serve_steps_batch1",
                     tmp_path_factory.mktemp("batch1"),
                     {arch: w for arch, (w, _) in gold.items()})


@pytest.mark.parametrize("arch", M.BATCH1_ARCHS)
def test_batch1_sequence_split_over_data_gives_the_meshless_tokens(
        gold, batch1, arch):
    weights, want = gold[arch]
    cfg = M.batch1_cfg(arch)
    one = M.mesh_greedy(cfg, PP.params_from_numpy(weights, "cpu"),
                        M.batch1_prompt(cfg), STEPS, MAX_SEQ)
    split = [name for name, pl in batch1[0][arch][2].items()
             if pl is not None and "S(" in pl[0]]
    if arch != "mamba2-1p3b":
        assert split, batch1[0][arch][2]     # some leaf splits over "data"
    for got in batch1:
        tokens, first, _ = got[arch]
        np.testing.assert_array_equal(tokens, want)
        np.testing.assert_array_equal(tokens, one[0])
        np.testing.assert_array_equal(first, batch1[0][arch][1])
