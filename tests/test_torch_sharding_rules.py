"""The port's logical-axis sharding rules without a process group (mirror
of ``tests/test_sharding_rules.py``): specs are reckoned from a mesh
shape ({axis: size}).  Each rule case also holds the port's ``spec_for``
equal to the reference's on a ``Mesh`` of repeated host devices of the
same shape, and ``param_specs`` equals the reference's for every config
at its published widths."""

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh, PartitionSpec as JP

from repro import configs as jconfigs
from repro.distributed import sharding as JS
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.distributed.sharding import (DEFAULT_RULES, P, spec_for,
                                              use_rules, zero_shard_spec)
from repro_torch.models import registry
from repro_torch.models.params import tree_leaves, tree_map


def _mesh(shape=(4, 2), axes=("data", "model")):
    """The reference test's mesh of repeated host devices."""
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def _shape(shape=(4, 2), axes=("data", "model")):
    return dict(zip(axes, shape))


def same_as_reference(axes, dims, shape=(4, 2), names=("data", "model")):
    """The port's spec for (axes, dims), asserted equal to the
    reference's on the same mesh shape."""
    got = spec_for(axes, _shape(shape, names), dims)
    want = JS.spec_for(axes, _mesh(shape, names), dims)
    assert tuple(got) == tuple(want), (axes, dims, got, want)
    return got


AXIS_NAMES = [None, "batch", "vocab", "heads", "kv_heads", "ff",
              "experts", "embed", "kv_seq", "seq_sharded", "stack"]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(AXIS_NAMES),
                          st.integers(min_value=1, max_value=64)),
                min_size=1, max_size=4))
def test_specs_always_divide(dims_axes):
    """Property: whatever logical axes and dims, the spec's mesh-axis
    product divides every dim, and it equals the reference's."""
    mesh = _shape()
    axes = tuple(a for a, _ in dims_axes)
    shape = tuple(d for _, d in dims_axes)
    spec = same_as_reference(axes, shape)
    for dim, part in zip(shape, tuple(spec)):
        if part is None:
            continue
        names = (part,) if isinstance(part, str) else part
        prod = 1
        for n in names:
            prod *= mesh[n]
        assert dim % prod == 0, (axes, shape, spec)


def test_axis_not_consumed_when_indivisible():
    """The qwen-decode regression: a non-divisible dim must not consume
    the mesh axis; a later dim claims it."""
    spec = same_as_reference(("batch", "kv_heads", "kv_seq", None),
                             (8, 6, 32, 128), (2, 4))
    assert tuple(spec) == ("data", None, "model", None)


def test_no_axis_used_twice():
    spec = same_as_reference(("vocab", "ff"), (64, 64), (2, 4))
    flat = []
    for part in tuple(spec):
        if part is None:
            continue
        flat.extend((part,) if isinstance(part, str) else part)
    assert len(flat) == len(set(flat))


def test_rules_override_context():
    with use_rules({"ff": None}), JS.use_rules({"ff": None}):
        assert tuple(same_as_reference(("ff",), (64,))) == (None,)
    assert tuple(same_as_reference(("ff",), (64,))) == ("model",)
    assert DEFAULT_RULES["ff"] == JS.DEFAULT_RULES["ff"]


def test_multi_axis_batch_and_no_mesh():
    """Batch over (pod, data) on a 3-axis mesh, and no mesh at all (every
    entry None), each as the reference's."""
    spec = same_as_reference(("batch", None, "heads"), (8, 3, 16),
                             (2, 2, 2), ("pod", "data", "model"))
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert tuple(spec_for(("batch", "heads"), None, (8, 16))) == (None, None)


@pytest.mark.parametrize("spec,shape,want", [
    (P(None, "model"), (8, 16), ("data", "model")),
    (P(None, "model"), (6, 16), (None, "model")),   # indivisible: unchanged
])
def test_zero_shard_spec(spec, shape, want):
    got = zero_shard_spec(spec, shape, _shape())
    assert tuple(got) == want
    assert tuple(got) == tuple(JS.zero_shard_spec(JP(*spec), shape, _mesh()))


def test_gemma3_cache_geometry():
    """Local layers hold ring caches of window size; global layers hold
    full-length caches; MLA caches store lora+rope, not heads."""
    g = configs.get("gemma3-12b")
    cd = registry.cache_decls(g, batch=4, max_seq=32768)
    shapes = {"/".join(p): d.shape for p, d in _decl_items(cd)}
    local_k = [s for k, s in shapes.items() if "local" in k and k.endswith("k")]
    global_k = [s for k, s in shapes.items()
                if "global" in k and k.endswith("k")]
    assert local_k and local_k[0][-2] == g.sliding_window
    assert global_k and global_k[0][-2] == 32768

    ds = configs.get("deepseek-v2-lite-16b")
    ckv = [d.shape for p, d in _decl_items(registry.cache_decls(ds, 4, 1024))
           if p[-1] == "c_kv"]
    assert ckv and ckv[0][-1] == ds.kv_lora_rank   # compressed, no heads


def _decl_items(tree):
    out = []
    tree_map(lambda p, d: out.append((p, d)), tree)
    return out


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_specs_equal_reference(arch):
    """``registry.specs`` at the published widths equals the reference's
    on (4, 2) and on the production (16, 16) mesh shape, leaf for leaf."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for shape in ((4, 2), (16, 16)):
        got = registry.specs(cfg, _shape(shape))
        want = jregistry.specs(jcfg, _mesh(shape))
        paths = [p for p, _ in _decl_items(got)]
        want_flat = {"/".join(str(getattr(k, "key", k)) for k in p): s
                     for p, s in jax.tree_util.tree_flatten_with_path(
                         want, is_leaf=lambda x: isinstance(x, JP))[0]}
        assert len(paths) == len(want_flat) == len(tree_leaves(got))
        for p in paths:
            s = got
            for k in p:
                s = s[k]
            assert tuple(s) == tuple(want_flat["/".join(p)]), (arch, p)


def test_production_and_host_mesh_builders(monkeypatch):
    """``launch.mesh`` asks ``init_device_mesh`` for the reference's
    production shapes and axis names (recorded, not built: 256 ranks)."""
    import torch.distributed.device_mesh as DM
    from repro_torch.launch import mesh as M
    calls = []
    monkeypatch.setattr(DM, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: calls.append(
                            (dev, shape, mesh_dim_names)))
    M.make_production_mesh()
    M.make_production_mesh(multi_pod=True)
    M.make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
    assert calls == [("cuda", (16, 16), ("data", "model")),
                     ("cuda", (2, 16, 16), ("pod", "data", "model")),
                     ("cpu", (4, 2), ("data", "model"))]
    with pytest.raises(ValueError, match="rank"):
        M.make_host_mesh((4, 2), ("data",))
