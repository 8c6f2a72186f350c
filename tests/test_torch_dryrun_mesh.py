"""The dry-run on a ``DeviceMesh`` (ROADMAP A13c), on ranks of torch's
``fake`` process-group backend in this one process
(``launch.dryrun.fake_world``): the counter's collective term and its
per-device counts against the reference's HLO walker.

* The mirror of ``tests/test_roofline.py::test_collective_bytes_counted``:
  an 8-way sum then replicate counts at least one all-reduce of a
  (128, 128) fp32 tile.
* A DTensor op counts its local shard's FLOPs, not the global shape's.
* The mirror of ``test_collective_parse_kinds``: each kind by its
  bytes (the all-gather by its result), GPipe's point-to-point sends as
  ``collective-permute``.
* One smoke cell of each kind (train, prefill, decode) counted on a
  (2, 4) mesh against the reference's ``launch.dryrun.lower_cell`` on the
  same cell and mesh, walked by ``roofline/hlo_walk.walk`` in a
  subprocess with 8 host devices: per-device FLOPs within 1.0-1.05 of
  the reference's; the bytes ratio is printed (``-s``).
* The CLI with ``--multi-pod`` counts a cell on 2x16x16 (512 fake
  ranks), with collective bytes."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from _subproc import check
from repro_torch import configs
from repro_torch.configs.base import ShapeCfg, smoke_variant
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import count as C

torch.set_num_threads(2)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
KINDS = ("train", "prefill", "decode")
FLOPS_BAND = (1.0, 1.05)


@pytest.fixture(scope="module")
def world8():
    with dryrun.fake_world(8):
        yield


def test_collective_bytes_counted(world8):
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_host_mesh((8,), ("x",), device_type="cpu")
    fake = C.fake_mode()
    x = dryrun.SH.Sharding(mesh, dryrun.SH.P("x")).abstract(
        (8, 128, 128), torch.float32, fake)
    assert x.placements == (Shard(0),)
    with fake:
        _, costs = C.count(lambda v: v.sum(0).redistribute(
            mesh, [Replicate()]), x)
    # sum over the sharded axis then replicate: at least one all-reduce
    # of a (128, 128) f32 = 65536 bytes.
    assert costs.coll["total"] >= 128 * 128 * 4, costs.coll
    assert costs.coll["all-reduce"] == 128 * 128 * 4
    assert costs.flops == 0


def test_dtensor_op_counts_its_local_flops_only(world8):
    """A matmul of a DTensor split 8 ways counts one shard's FLOPs: the
    global-shape inference DTensor runs on fake tensors (which the
    counter marks through torch's private ``ShardingPropagator`` hook)
    adds none, and a torch that renames the hook fails here."""
    mesh = make_host_mesh((8,), ("x",), device_type="cpu")
    fake = C.fake_mode()
    x = dryrun.SH.Sharding(mesh, dryrun.SH.P("x")).abstract(
        (8, 64, 128), torch.float32, fake)
    w = dryrun.SH.Sharding(mesh, dryrun.SH.P()).abstract(
        (128, 32), torch.float32, fake)
    with fake:
        out, costs = C.count(lambda a, b: a @ b, x, w)
    assert out.to_local().shape == (1, 64, 32)
    assert costs.flops == 2 * 64 * 128 * 32
    assert costs.coll["total"] == 0


def test_collective_kinds(world8):
    mesh = make_host_mesh((2, 4), ("data", "model"), device_type="cpu")
    model, data = mesh.get_group("model"), mesh.get_group("data")
    fake = C.fake_mode()
    with fake:
        x = torch.zeros(256)
        with C.Counter() as c:
            funcol.all_reduce(x, "sum", model)
            funcol.all_gather_tensor(x, 0, data)       # 2 ranks: f32[512]
            funcol.reduce_scatter_tensor(x, "sum", 0, model)
            funcol.all_to_all_single(x, None, None, model)
    assert c.costs.coll == {"all-reduce": 1024, "all-gather": 2048,
                            "reduce-scatter": 1024, "all-to-all": 1024,
                            "total": 5120}
    with C.Counter() as c:
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, torch.zeros(256), 1, group=model)]):
            req.wait()
    assert c.costs.coll == {"collective-permute": 1024, "total": 1024}
    roof = RA.analyze(c.costs, smoke_variant(configs.get("minitron-4b")),
                      ShapeCfg("x", "decode", 8, 1), "2x4", 8, 1)
    assert roof.collectives["collective-permute"] == 1024
    assert roof.t_collective == 1024 / RA.hw.NVLINK_BW


_REFERENCE = """
import dataclasses, json
import jax
from repro import configs
from repro.configs.base import smoke_variant, ShapeCfg
from repro.launch import dryrun
from repro.roofline import hlo_walk as W
cfg = dataclasses.replace(smoke_variant(configs.get("minitron-4b")),
                          remat="none", vocab_size=512)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for kind in ("train", "prefill", "decode"):
    compiled, _ = dryrun.lower_cell(cfg, ShapeCfg("x", kind, 64, 8), mesh)
    c = W.walk(compiled.as_text())
    out[kind] = [c.flops, c.bytes, c.coll.get("total", 0.0)]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = check(_REFERENCE, n_devices=8)
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_cell_counts_match_the_reference_walker(world8, reference,
                                                      kind):
    cfg = dataclasses.replace(smoke_variant(configs.get("minitron-4b")),
                              remat="none", vocab_size=512)
    mesh = make_host_mesh((2, 4), ("data", "model"), device_type="cpu")
    costs, _ = dryrun.lower_cell(cfg, ShapeCfg("x", kind, 64, 8), mesh,
                                 scopes=False)
    flops, nbytes, coll = reference[kind]
    ratio = costs.flops / flops
    print(f"minitron {kind} on (2, 4): FLOPs port/reference {ratio:.4f}, "
          f"bytes {costs.bytes / nbytes:.3f}, collective bytes "
          f"{costs.coll['total']:.0f} against {coll:.0f}")
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], (costs.flops, flops)
    assert costs.coll["total"] > 0


def test_cli_multi_pod_builds_2x16x16():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "minitron-4b", "--shape", "decode_32k",
                        "--multi-pod", "--quiet"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("PASS"))
    assert "minitron-4b × decode_32k × 2x16x16" in line
    coll = float(line.split("coll=")[1].split("B")[0])
    assert coll > 0
    assert "1 passed, 0 failed" in r.stdout
