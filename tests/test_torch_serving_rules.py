"""Sharded serving without a process group (mirror of
``tests/test_sharded_serving.py``'s in-process half): the shardability
checks, word for word the reference's; the shard-local config; the
serving mesh's refusals; the CLI's refusals before any process group
starts.  And two properties of the port's design: the collective
helpers are the identity outside ``manual_axis``, and every paged
family's parameters and pools, cut into each rank's tiles and glued back
(``serve_loop.cut_tiles`` / ``glue_tiles``), come back bit for bit, with
the specs equal to the reference's on a mesh of repeated host
devices."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.configs.base import smoke_variant as jsmoke
from repro.distributed.sharding import validate_shardable as jvalidate
from repro.serve import serve_loop as jserve_loop
from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import validate_shardable
from repro_torch.launch.mesh import serving_mesh
from repro_torch.models import params as PP
from repro_torch.models import registry
from repro_torch.models.cache_layouts import get_layout
from repro_torch.serve.serve_loop import (cut_tiles, glue_tiles, local_decls,
                                          paged_sharding_specs,
                                          serving_sizes, shard_local_cfg)


def _pair(arch):
    return smoke_variant(configs.get(arch)), jsmoke(jconfigs.get(arch))


def _same_refusal(arch, tp, **kw):
    """The port's and the reference's ``validate_shardable`` on the same
    config: both pass, or both raise the same message."""
    cfg, jcfg = _pair(arch)
    cfg, jcfg = (dataclasses.replace(c, **kw) for c in (cfg, jcfg))
    errs = []
    for fn, c in ((validate_shardable, cfg), (jvalidate, jcfg)):
        try:
            fn(c, tp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1], errs
    return errs[0]


# --- launch-time shardability validation ---------------------------------------


def test_validate_shardable_names_dim_and_knob():
    """minitron smoke (4 q / 4 kv heads): tp 1 and 2 pass; each bad dim is
    named with its knob, in the reference's words."""
    assert _same_refusal("minitron-4b", 1) is None
    assert _same_refusal("minitron-4b", 2) is None
    err = _same_refusal("minitron-4b", 3)
    assert "n_heads" in err and "mesh_shape[-1] = 3" in err
    assert "n_kv_heads" in _same_refusal("minitron-4b", 2, n_kv_heads=1)
    assert "d_ff" in _same_refusal("minitron-4b", 2, d_ff=255)
    assert "fuse_qkv" in _same_refusal("minitron-4b", 2, fuse_qkv=True)


def test_validate_shardable_mla_and_moe_dims():
    """MLA pools page over the latent dim, so that is the dim named (not
    n_kv_heads); the expert hidden dim is named for MoE."""
    assert _same_refusal("deepseek-v2-lite-16b", 2) is None
    assert "kv_lora_rank" in _same_refusal("deepseek-v2-lite-16b", 2,
                                           kv_lora_rank=33)
    assert _same_refusal("phi3p5-moe-42b", 4) is None
    assert "moe_d_ff" in _same_refusal("phi3p5-moe-42b", 4, moe_d_ff=66)


def test_shard_local_cfg_divides_ranked_dims_only():
    cfg = dataclasses.replace(smoke_variant(configs.get("minitron-4b")),
                              mesh_shape=(1, 2))
    loc = shard_local_cfg(cfg)
    assert loc.n_heads == cfg.n_heads // 2
    assert loc.n_kv_heads == cfg.n_kv_heads // 2
    assert loc.d_ff == cfg.d_ff // 2
    assert loc.mesh_shape == ()          # the body must not re-shard
    assert loc.vocab_size == cfg.vocab_size  # logits tile gathers instead
    mla = dataclasses.replace(
        smoke_variant(configs.get("deepseek-v2-lite-16b")),
        mesh_shape=(1, 2))
    ml = shard_local_cfg(mla)
    # MLA keeps the FULL latent rank in the forward (w_dkv replicated);
    # only the latent page POOL splits, sliced at the cache write.
    assert ml.kv_lora_rank == mla.kv_lora_rank
    assert ml.n_heads == mla.n_heads // 2
    moe = dataclasses.replace(smoke_variant(configs.get("phi3p5-moe-42b")),
                              mesh_shape=(4,))
    assert shard_local_cfg(moe).moe_d_ff == moe.moe_d_ff // 4
    # the reference's local config has the same dims.
    jmla = dataclasses.replace(
        jsmoke(jconfigs.get("deepseek-v2-lite-16b")), mesh_shape=(1, 2))
    jl = jserve_loop.shard_local_cfg(jmla)
    for f in ("n_heads", "n_kv_heads", "d_ff", "moe_d_ff", "kv_lora_rank",
              "vocab_size", "mesh_shape"):
        assert getattr(ml, f) == getattr(jl, f), f


def test_serving_mesh_refuses_missing_ranks_and_bad_axes():
    """No process group here: the error names the launcher that gives
    the ranks; a tp axis other than the last and a rank above 3 are
    refused as the reference refuses them."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        serving_mesh((1, 2), device_type="cpu")
    with pytest.raises(ValueError, match="tp_axis"):
        serving_mesh((1,), tp_axis="ff", device_type="cpu")
    with pytest.raises(ValueError, match="rank"):
        serving_mesh((1, 1, 1, 1), device_type="cpu")
    with pytest.raises(ValueError, match="empty"):
        serving_mesh((), device_type="cpu")


def test_launch_cli_rejects_bad_mesh_before_any_group(capsys):
    from repro_torch.launch.serve import main
    base = ["--arch", "minitron-4b", "--smoke", "--device", "cpu"]
    with pytest.raises(SystemExit):
        main(base + ["--page-size", "8", "--mesh", "3"])
    assert "n_heads" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(base + ["--mesh", "2"])
    assert "--page-size" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(base + ["--page-size", "8", "--mesh", "2x"])
    assert "INTxINT" in capsys.readouterr().err
    # no launcher: one process cannot be a 2-rank mesh.
    with pytest.raises(SystemExit):
        main(base + ["--page-size", "8", "--mesh", "1x2"])
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    assert not dist.is_initialized()


# --- the port's design: identity helpers, tiles that glue back ---------------------


def test_collective_helpers_are_identity_without_a_manual_axis():
    x = torch.randn(3, 8)
    assert SH.active_manual_axis() is None
    for ctx in (None, SH.manual_axis(None)):
        if ctx is not None:
            ctx.__enter__()
        assert SH.psum_parts(x) is x
        assert SH.gather_parts(x, 1) is x
        assert SH.part_index() == 0 and SH.part_count() == 1
        if ctx is not None:
            ctx.__exit__(None, None, None)
    assert SH.active_manual_axis() is None


FAMILIES = [("minitron-4b", {}), ("minitron-4b", {"kv_cache_dtype": "int8"}),
            ("gemma3-12b", {}), ("deepseek-v2-lite-16b", {}),
            ("phi3p5-moe-42b", {})]


def _random_like(decls, seed):
    gen = torch.Generator().manual_seed(seed)

    def one(_, d):
        if d.dtype == torch.int8:
            return torch.randint(-127, 128, d.shape, generator=gen,
                                 dtype=torch.int8)
        return torch.randn(d.shape, generator=gen).to(d.dtype)
    return PP.tree_map(one, decls)


def _ranks(sizes):
    """Every rank's {axis: index}, rank-major over ``sizes``' axes."""
    axes = list(sizes)
    out = []
    for r in range(int(np.prod(list(sizes.values())))):
        c = {}
        for a in reversed(axes):
            r, c[a] = divmod(r, sizes[a])
        out.append(c)
    return out


@pytest.mark.parametrize("arch,kw", FAMILIES,
                         ids=["gqa", "int8", "gemma3", "mla", "moe"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4,)])
def test_tiles_glue_back_bit_for_bit(arch, kw, shape):
    """Parameters and pools of every paged family cut into each rank's
    tiles and glued back give the same bits; each tile has the shape
    ``local_decls`` gives; MLA's k_rope pages and every family's token
    embedding stay whole, MoE's experts are not split (their ff dims
    are)."""
    cfg = dataclasses.replace(smoke_variant(configs.get(arch)),
                              mesh_shape=shape, **kw)
    validate_shardable(cfg, shape[-1])
    page = 8
    sizes = serving_sizes(cfg)
    p_specs, pool_specs = paged_sharding_specs(cfg, page)
    layout = get_layout(cfg, page)
    pool_decls = registry.paged_cache_decls(
        cfg, {g.name: 6 for g in layout.groups}, page)
    trees = {"params": (registry.init(cfg, seed=0, device="cpu"), p_specs,
                        registry.decls(cfg)),
             "pools": (_random_like(pool_decls, 1), pool_specs, pool_decls)}
    tp = shape[-1]
    for name, (full, specs, decls) in trees.items():
        tiles = [cut_tiles(full, specs, sizes, c) for c in _ranks(sizes)]
        want_shapes = local_decls(decls, specs, sizes)
        for t in tiles:
            for a, d in zip(PP.tree_leaves(t), PP.tree_leaves(want_shapes)):
                assert tuple(a.shape) == d.shape
        back = glue_tiles(tiles, specs, sizes)
        for a, b in zip(PP.tree_leaves(back), PP.tree_leaves(full)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        split = sum(a.numel() for a in PP.tree_leaves(tiles[0]))
        whole = sum(a.numel() for a in PP.tree_leaves(full))
        assert split < whole
        if name == "pools" and not cfg.mla:
            assert split * tp == whole
    assert tuple(p_specs["embed"]) == ()
    if cfg.mla:
        lat = pool_specs["latent"]["rest"]
        assert tuple(lat["k_rope"]) == (None,) * 4
        assert tuple(lat["c_kv"])[-1] == "model"
    if cfg.n_experts:
        gates = [w for path, w in _flat(p_specs).items()
                 if path[-2:] == ("moe", "w_gate")]
        assert gates and all(w[-3] is None and w[-1] == "model"
                             for w in gates)


@pytest.mark.parametrize("arch,kw", FAMILIES,
                         ids=["gqa", "int8", "gemma3", "mla", "moe"])
def test_layout_alone_decides_the_pool_tiling(arch, kw):
    """``CacheLayout.tp_dims`` comes from the rules' table alone (the same
    with and without ``mesh_shape``); ``pool_specs`` on a mesh names
    "model" at those dims and nowhere else; ``page_nbytes`` is a whole
    pool's bytes over its pages."""
    base = dataclasses.replace(smoke_variant(configs.get(arch)), **kw)
    page, n = 8, 6
    plain = get_layout(base, page)
    meshed = get_layout(dataclasses.replace(base, mesh_shape=(1, 2)), page)
    assert plain.tp_dims == meshed.tp_dims
    specs = plain.pool_specs({"data": 2, "model": 2})
    dims = PP.tree_leaves(plain.tp_dims)
    for spec, dim in zip(PP.tree_leaves(specs), dims):
        assert [i for i, part in enumerate(spec) if part] == (
            [] if dim is None else [dim])
        assert dim is None or spec[dim] == "model"
    pools = registry.paged_cache_decls(
        base, {g.name: n for g in plain.groups}, page)
    for g in plain.groups:
        whole = sum(int(np.prod(d.shape)) * d.dtype.itemsize
                    for d in PP.tree_leaves(pools[g.name]))
        assert plain.page_nbytes(g.name) * n == whole


@pytest.mark.parametrize("arch,kw", FAMILIES,
                         ids=["gqa", "int8", "gemma3", "mla", "moe"])
def test_specs_equal_the_reference(arch, kw):
    """``paged_sharding_specs`` equals the reference's on a (1, 2) mesh
    of repeated host devices, for the parameters and the pools."""
    cfg = dataclasses.replace(smoke_variant(configs.get(arch)),
                              mesh_shape=(1, 2), **kw)
    jcfg = dataclasses.replace(jsmoke(jconfigs.get(arch)),
                               mesh_shape=(1, 2), **kw)
    mesh = Mesh(np.array(jax.devices() * 2)[:2].reshape(1, 2),
                ("data", "model"))
    got = paged_sharding_specs(cfg, 8)
    want = jserve_loop.paged_sharding_specs(jcfg, 8, mesh)
    for g, w in zip(got, want):
        assert _flat(g) == _flat(w)


def _flat(tree, path=()):
    """{path: spec as a tuple} of a nested dict of specs."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, path + (name,)).items()}
    return {path: tuple(tree)}


@pytest.mark.parametrize("arch,page", [("minitron-4b", 0),
                                       ("mamba2-1p3b", 8)])
def test_mesh_without_page_layout_serves_unsharded(arch, page):
    """As the reference's batcher: the mesh is for the paged path only.
    Dense slots (no page size) and a family with no page layout (ssm,
    asked for pages) serve unsharded with ``mesh_shape`` set, on one
    process with no process group: no mesh, no mesh stats, the same
    tokens as without ``mesh_shape``."""
    import _torch_serve_rank_fns as R
    from repro.serve import batching as jbatching
    cfg = dataclasses.replace(smoke_variant(configs.get(arch)),
                              kv_page_size=page)
    mcfg = dataclasses.replace(cfg, mesh_shape=(1, 2))
    params = registry.init(cfg, seed=0, device="cpu")
    want, _ = R.serve(cfg, params, R.PROMPTS[:2], [5, 5])
    got, bat = R.serve(mcfg, params, R.PROMPTS[:2], [5, 5])
    assert got == want
    assert bat.mesh is None and not bat.paged
    assert "mesh" not in bat.stats() and not dist.is_initialized()
    # the reference's batcher takes the same path: no mesh, not paged.
    from repro.models import registry as jregistry
    jcfg = dataclasses.replace(jsmoke(jconfigs.get(arch)), kv_page_size=page,
                               mesh_shape=(1, 2))
    jbat = jbatching.ContinuousBatcher(jcfg, jregistry.init(jcfg, 0),
                                       n_slots=2, max_seq=48)
    assert jbat.mesh is None and not jbat.paged
