"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's on the same smoke cells with no mesh.

The port counts its steps on fake CPU tensors with the roofline counter;
the reference compiles them with XLA and walks the HLO
(``roofline/hlo_walk.walk``).  Matmul FLOPs must agree within 10%.
Bytes must agree within 2x once the reference's per-layer
``dynamic-slice`` copies are set aside: its scan over stacked layers
copies each layer's weights out of the stacks (the walker charges each
copy three times the slice), where the port's loop reads a layer's slice
in place (a view, free in both byte models); on minitron's decode cell
the bytes set aside are exactly those copies.  The raw ratios (the
copies kept) must lie within 2x too, but for decode, where the copies
are most of the reference's traffic: there the raw ratio is 0.45 and is
held above 0.4.  Also: ``num_active_params`` and ``input_specs`` equal to
the reference's for every arch and shape, the reference's small-mesh
dry-run test at one device, and the CLI."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeCfg as JShape
from repro.configs.base import smoke_variant as jsmoke
from repro.models import registry as jregistry
from repro.roofline import hlo_walk as W
from repro.serve import serve_loop as JSL
from repro.train import optimizer as JOPT
from repro.train import train_loop as JTL
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.launch import dryrun
from repro_torch.models import registry as tregistry
from repro_torch.roofline import analysis as RA
from repro_torch.train import train_loop as TL

torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
FLOPS_REL = 0.10
BYTES_FACTOR = 2.0
RAW_LOW = {"decode": 0.4}    # raw bytes: the lower end where not 1/2


def _reference_hlo(arch, kind, b, s):
    cfg = dataclasses.replace(jsmoke(jconfigs.get(arch)), remat="none",
                              vocab_size=512)
    params = jregistry.init(cfg, 0)
    spec = jregistry.input_specs(cfg, JShape("x", kind, s, b))
    if kind == "train":
        fn, _, _ = JTL.make_train_step(cfg, JTL.TrainCfg(
            compress_grads=False), mesh=None, donate=False)
        batch = jregistry.make_batch(cfg, "train", b, s)
        lowered = fn.lower(params, JOPT.init(params), batch)
    elif kind == "prefill":
        pre, _, _, _ = JSL.make_serve_steps(cfg, b, s, None)
        lowered = pre.lower(params, spec)
    else:
        _, dec, ab_cache, _ = JSL.make_serve_steps(cfg, b, s, None)
        lowered = dec.lower(params, ab_cache, spec,
                            jax.ShapeDtypeStruct((), jnp.int32))
    return lowered.compile().as_text()


def _walk_without_slices(hlo):
    """The walker with every dynamic-slice (alone, or as the only
    non-free op of a fusion) charged nothing."""
    fusion_bytes, op_bytes = W._fusion_bytes, W._op_bytes

    def fusion(op, comp, comps):
        f = comps.get(op.called[0]) if op.called else None
        if f is not None and ({o.opcode for o in f.ops} - W._FREE_OPS
                              - W._ELEMENTWISE) == {"dynamic-slice"}:
            return 0.0
        return fusion_bytes(op, comp, comps)

    W._fusion_bytes = fusion
    W._op_bytes = lambda op, comp: (0.0 if op.opcode == "dynamic-slice"
                                    else op_bytes(op, comp))
    try:
        return W.walk(hlo)
    finally:
        W._fusion_bytes, W._op_bytes = fusion_bytes, op_bytes


@pytest.mark.parametrize("arch,kind", [
    ("minitron-4b", "train"), ("minitron-4b", "prefill"),
    ("minitron-4b", "decode"), ("phi3p5-moe-42b", "train"),
    ("phi3p5-moe-42b", "prefill")])
def test_counts_match_the_reference_walker(arch, kind):
    b, s = 2, 64
    hlo = _reference_hlo(arch, kind, b, s)
    ref, ref_kept = W.walk(hlo), _walk_without_slices(hlo)
    cfg = dataclasses.replace(tsmoke(tconfigs.get(arch)), remat="none",
                              vocab_size=512)
    costs, _ = dryrun.lower_cell(cfg, ShapeCfg("x", kind, s, b),
                                 tcfg=TL.TrainCfg(compress_grads=False))
    flops = costs.flops / ref.flops
    raw, kept = costs.bytes / ref.bytes, costs.bytes / ref_kept.bytes
    print(f"{arch} {kind}: FLOPs port/reference {flops:.4f}, bytes "
          f"{raw:.3f} raw, {kept:.3f} without the reference's slices")
    assert abs(flops - 1) <= FLOPS_REL, (costs.flops, ref.flops)
    assert 1 / BYTES_FACTOR <= kept <= BYTES_FACTOR, (costs.bytes,
                                                      ref_kept.bytes)
    assert RAW_LOW.get(kind, 1 / BYTES_FACTOR) <= raw <= BYTES_FACTOR, \
        (costs.bytes, ref.bytes)


def test_set_aside_bytes_are_the_layer_weight_copies():
    """What ``_walk_without_slices`` sets aside on minitron's decode cell
    is the copy of each layer's weights out of the stacks and nothing
    else: no cache slice (the cache's slice fusions also write the
    step's row, so they stay counted).  The walker charges a weight
    slice three times its size (the fusion's result, the slice it reads
    of the stack, and the slice again for the index parameter that only
    the slice uses); the norms' slices make up the last 0.3%."""
    hlo = _reference_hlo("minitron-4b", "decode", 2, 64)
    set_aside = W.walk(hlo).bytes - _walk_without_slices(hlo).bytes
    cfg = dataclasses.replace(jsmoke(jconfigs.get("minitron-4b")),
                              remat="none", vocab_size=512)
    mats = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(
        jregistry.init(cfg, 0)["blocks"]) if leaf.ndim == 3)
    assert 3 * mats <= set_aside <= 1.01 * 3 * mats, (set_aside, mats)


def test_num_active_params_match():
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    for name in jconfigs.ARCHS:
        assert tregistry.num_active_params(tconfigs.get(name)) == \
            jregistry.num_active_params(jconfigs.get(name)), name


def test_abstract_trees_match():
    """``registry.abstract`` and ``abstract_opt_state``: the reference's
    ShapeDtypeStruct trees, leaf for leaf (meta tensors, no storage)."""
    from repro.train import train_loop as jtl
    from repro_torch.models import params as tparams
    for name in jconfigs.ARCHS:
        want = jregistry.abstract(jconfigs.get(name))
        got = tregistry.abstract(tconfigs.get(name))
        opt = TL.abstract_opt_state(got)
        jopt = jtl.abstract_opt_state(want)

        def hold(path, leaf, want=want, jopt=jopt, opt=opt):
            spec, jm, m = want, jopt.m, opt.m
            for key in path:
                spec, jm, m = spec[key], jm[key], m[key]
            assert tuple(leaf.shape) == spec.shape, (name, path)
            assert str(leaf.dtype).split(".")[-1] == str(spec.dtype)
            assert leaf.device.type == "meta"
            assert tuple(m.shape) == jm.shape and m.dtype == torch.float32

        tparams.tree_map(hold, got)
        assert int(opt.step) == 0


def test_input_specs_match():
    """Every (arch x shape) the dry-run counts: the same leaves, shapes
    and dtypes as the reference's ShapeDtypeStructs."""
    n = 0
    for cfg, shape in dryrun.cells():
        jcfg = jconfigs.get(cfg.name)
        got = tregistry.input_specs(cfg, shape)
        want = jregistry.input_specs(jcfg, _jshape(shape))
        assert set(got) == set(want), (cfg.name, shape.name)
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (cfg.name, k)
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), \
                (cfg.name, k)
            assert got[k].device.type == "meta"
        n += 1
    # the reference's cells (its dryrun module is not imported: it sets
    # XLA_FLAGS for 512 host devices at import).
    want_n = sum(1 for a in jconfigs.ARCHS for sh in jconfigs.SHAPES
                 if sh != "long_500k" or a in jconfigs.LONG_CONTEXT_ARCHS)
    assert n == want_n == 33


def _jshape(shape):
    return JShape(shape.name, shape.kind, shape.seq_len, shape.global_batch)


def test_dryrun_machinery_one_device():
    """The reference's ``test_dryrun_machinery_small_mesh`` at one device:
    build + count + roofline of a smoke train cell with the production
    train settings (4 microbatches)."""
    cfg = tsmoke(tconfigs.get("minitron-4b"))
    shape = ShapeCfg("train_tiny", "train", 64, 8)
    costs, dt = dryrun.lower_cell(cfg, shape)
    roof = RA.analyze(costs, cfg, shape, "1", 1,
                      tregistry.num_active_params(cfg))
    rec = roof.to_dict(1)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["collective_bytes_per_device"] == 0 and rec["mesh"] == "1"
    assert rec["scopes_flops"] and dt > 0


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_counts_a_full_size_cell():
    r = _cli("--arch", "minitron-4b", "--shape", "decode_32k")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS minitron-4b × decode_32k × 1" in r.stdout
    assert "1 passed, 0 failed" in r.stdout
    r = _cli("--all", "--multi-pod")
    assert r.returncode != 0 and "A13b" in r.stderr
