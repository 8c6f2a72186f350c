"""Port parity: configs and parameter trees (``repro_torch`` vs ``repro``).

Every field of every architecture and of its smoke variant, the
parameter count, and every leaf's path, shape and dtype must match the
JAX package; weights carried across with ``params_from_numpy`` must be
bit-identical, bf16 included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.models import params as tparams
from repro_torch.models import registry as tregistry

torch.set_num_threads(2)

ARCHS = sorted(jconfigs.ARCHS)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def test_arch_registry_matches():
    assert sorted(tconfigs.ARCHS) == ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for alias in jconfigs.ALIASES:
        assert tconfigs.get(alias).name == jconfigs.get(alias).name
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


@pytest.mark.parametrize("name", ARCHS)
def test_config_fields_match(name):
    jc, tc = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    assert [f.name for f in dataclasses.fields(tc)] == \
        [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tsmoke(tc)) == dataclasses.asdict(jsmoke(jc))
    for c_t, c_j in ((tc, jc), (tsmoke(tc), jsmoke(jc))):
        assert c_t.padded_vocab == c_j.padded_vocab
        assert c_t.d_inner == c_j.d_inner and c_t.ssm_heads == c_j.ssm_heads
        assert c_t.group_layout == c_j.group_layout


def test_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tconfigs.MODEL_AXIS == jconfigs.MODEL_AXIS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_param_decls_match(name, smoke):
    jc, tc = jconfigs.ARCHS[name], tconfigs.ARCHS[name]
    if smoke:
        jc, tc = jsmoke(jc), tsmoke(tc)
    jd, td = _flat(jregistry.decls(jc)), _flat(tregistry.decls(tc))
    assert sorted(td) == sorted(jd)
    for path, d in jd.items():
        t = td[path]
        assert t.shape == d.shape, path
        assert t.axes == d.axes, path
        assert _dtype_name(t.dtype) == _dtype_name(d.dtype), path
        assert (t.init, t.std) == (d.init, d.std), path
    assert tregistry.num_params(tc) == jregistry.num_params(jc)
    assert tc.param_count_dense() == jc.param_count_dense()


def test_params_from_numpy_bit_identical_fp32_and_bf16():
    cfg = jsmoke(jconfigs.get("minitron-4b"))
    jp = jregistry.init(cfg, 0)
    host = _flat({k: v for k, v in jp.items()})
    tp = _flat(tparams.params_from_numpy(
        tparams.tree_map(lambda _, a: np.asarray(a), jp), "cpu"))
    for path, a in host.items():
        assert tp[path].dtype == torch.float32
        assert np.array_equal(tp[path].numpy(), np.asarray(a)), path
    # ml_dtypes bfloat16 arrives by its bits, without ml_dtypes in the port.
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.float32).astype(jnp.bfloat16)
    t = tparams.params_from_numpy({"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))
    recast = tparams.params_from_numpy({"w": np.asarray(x)}, "cpu",
                                       dtype=torch.float32)["w"]
    assert recast.dtype == torch.float32
    with pytest.raises(TypeError):
        tparams.params_from_numpy({"w": np.zeros(3, np.complex64)}, "cpu")


def test_init_params_deterministic_per_path_and_in_requested_dtype():
    cfg = tsmoke(tconfigs.get("minitron-4b"))
    a = tregistry.init(cfg, 0, device="cpu")
    b = tregistry.init(cfg, 0, device="cpu")
    c = tregistry.init(cfg, 1, device="cpu")
    fa, fb, fc = _flat(a), _flat(b), _flat(c)
    for path in fa:
        assert torch.equal(fa[path], fb[path]), path
    assert not torch.equal(fa["blocks/attn/wq"], fc["blocks/attn/wq"])
    # zeros-initialized gains, fan-in scaled normals, embed_std override.
    assert torch.count_nonzero(fa["blocks/attn/norm"]) == 0
    assert abs(fa["embed"].std().item() - cfg.embed_std) < 2e-3
    fan_in = cfg.d_model
    assert abs(fa["blocks/attn/wq"].std().item() * np.sqrt(fan_in) - 1) < 0.05
    bf = _flat(tregistry.init(cfg, 0, device="cpu", dtype=torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    assert tparams.param_count(tregistry.decls(cfg)) == \
        sum(v.numel() for v in fa.values())
    cast = _flat(tparams.cast_tree(a, torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
