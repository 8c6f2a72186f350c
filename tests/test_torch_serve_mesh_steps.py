"""The dense-cache serve steps on a ``DeviceMesh`` (ROADMAP A13c), on gloo
ranks of the CPU (``_torch_mesh_rank_fns.serve_steps_mesh``):

* the port's mirror of
  ``tests/test_perf_flags.py::test_seq_sharded_int8_decode_distributed``:
  on (4, 2), qwen1p5-32b's smoke variant with an int8 cache and
  ``decode_seq_shard`` greedily decodes the JAX package's
  ``greedy_generate`` tokens on the same (bridged) parameters.  Its 4 kv
  heads take "model" there, so the sequence stays whole, as in the
  reference;
* on (1, 3) the 4 kv heads do not divide "model", so ``spec_for`` gives
  the cache's sequence dim to it: each rank holds 8 of 24 slots, writes
  only its own and reads its shard as split-KV partials; on the same
  bridged parameters the tokens equal the JAX package's
  ``greedy_generate`` with the same int8 cache, ``max_seq`` and steps,
  and the port's meshless steps, and every rank holds the same (batch
  1, the sequence over "data": ``test_torch_serve_mesh_batch1.py``);
* every ``cache_decls`` leaf's spec equals the reference's
  ``params.param_specs`` on the same mesh shape, for every architecture,
  at batch 1 and with ``decode_seq_shard``.  (zamba2's port stacks its
  Mamba layers' state flat where the reference nests it in groups and a
  tail; leaf by leaf the specs agree past the stacking dims.)"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_mesh_rank_fns as M
from _torch_ranks import run_ranks
from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import params as JPP
from repro.models import registry as jregistry
from repro.serve.serve_loop import greedy_generate as jgreedy
from repro_torch import configs
from repro_torch.models import params as PP
from repro_torch.models import registry

STEPS, MAX_SEQ = 4, 16


@pytest.fixture(scope="module")
def gold():
    """The reference test's case: JAX parameters, prompt and greedy
    tokens (bf16 cache, one device)."""
    jcfg = jsmoke(jconfigs.get("qwen1p5-32b"))
    jp = jregistry.init(jcfg, 0)
    prompt = jregistry.make_batch(jcfg, "prefill", 2, 8, seed=11)
    want = np.asarray(jgreedy(jcfg, jp, prompt, steps=STEPS,
                              max_seq=MAX_SEQ))
    weights = PP.tree_map(lambda _, a: np.asarray(a), jp)
    return weights, np.asarray(prompt["tokens"]).astype(np.int64), want


@pytest.fixture(scope="module")
def mesh42(gold, tmp_path_factory):
    weights, prompt, _ = gold
    return run_ranks(8, "_torch_mesh_rank_fns:serve_steps_mesh",
                     tmp_path_factory.mktemp("mesh42"), (4, 2),
                     ("data", "model"), weights, prompt, STEPS, MAX_SEQ)


def bridged_gold(jcfg, prompt, steps, max_seq):
    """(the JAX package's seed-0 parameters as numpy, its
    ``greedy_generate`` tokens of ``prompt``)."""
    jp = jregistry.init(jcfg, 0)
    want = np.asarray(jgreedy(jcfg, jp, {"tokens": prompt.astype(np.int32)},
                              steps=steps, max_seq=max_seq))
    return PP.tree_map(lambda _, a: np.asarray(a), jp), want


@pytest.fixture(scope="module")
def mesh13(tmp_path_factory):
    cfg = M.qwen_seq_cfg()
    jcfg = dataclasses.replace(jsmoke(jconfigs.get("qwen1p5-32b")),
                               kv_cache_dtype="int8", decode_seq_shard=True)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int64)
    weights, want = bridged_gold(jcfg, prompt, 8, 24)
    got = run_ranks(3, "_torch_mesh_rank_fns:serve_steps_mesh",
                    tmp_path_factory.mktemp("mesh13"), (1, 3),
                    ("data", "model"), weights, prompt, 8, 24)
    return prompt, weights, want, got


def test_seq_sharded_int8_decode_distributed(gold, mesh42):
    _, _, want = gold
    for got in mesh42:
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["specs"]["k"] == (None, None, "model", None, None)


def test_sequence_split_over_model_gives_the_meshless_tokens(mesh13):
    prompt, weights, want, got = mesh13
    cfg = M.qwen_seq_cfg()
    assert cfg.n_kv_heads % 3
    one = M.mesh_greedy(cfg, PP.params_from_numpy(weights, "cpu"),
                        prompt, 8, 24)
    for g in got:
        for name in ("k", "v", "k_scale", "v_scale"):
            assert g["specs"][name] == (None, "data", None, "model", None)
            assert g["placements"][name] == ("R", "S(3)")
        np.testing.assert_array_equal(g["tokens"], want)
        np.testing.assert_array_equal(g["tokens"], one[0])
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["first"], got[0]["first"])


def _jmesh(shape, axes):
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


MESHES = [((4, 2), ("data", "model")), ((1, 3), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _as_port(want):
    """The reference's hybrid cache specs in the port's layout (its
    ``groups`` / ``tail`` Mamba stacks as one flat stack), after checking
    that the groups' leaves carry the tail's spec past their extra
    stacking dim."""
    if "tail/conv" not in want:
        return want
    out = {}
    for key, spec in want.items():
        if key.startswith("groups/attn/"):
            out[key[len("groups/"):]] = spec
        elif key.startswith("tail/"):
            leaf = key[len("tail/"):]
            assert want["groups/ssm/" + leaf] == (None,) + spec, key
            out["ssm/" + leaf] = spec
    return out


@pytest.mark.parametrize("shape,axes", MESHES)
def test_cache_specs_equal_the_reference(shape, axes):
    sizes = dict(zip(axes, shape))
    jm = _jmesh(shape, axes)
    for name in configs.ARCHS:
        for kw in ({}, {"decode_seq_shard": True},
                   {"decode_seq_shard": True, "kv_cache_dtype": "int8"}):
            for batch, seq in ((128, 32768), (1, 524288), (2, 24)):
                tcfg = dataclasses.replace(configs.get(name), **kw)
                jcfg = dataclasses.replace(jconfigs.get(name), **kw)
                got = M.by_path(PP.param_specs(
                    registry.cache_decls(tcfg, batch, seq), sizes), tuple)
                want = _as_port(M.by_path(JPP.param_specs(
                    jregistry.cache_decls(jcfg, batch, seq), jm), tuple))
                assert got == want, (name, kw, batch, seq)
