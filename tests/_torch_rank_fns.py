"""Rank bodies of the multi-rank port tests (run by ``_torch_ranks``):
each takes (rank, world, *args) inside a gloo process group and returns
numpy arrays and floats.  Imports torch and the port only — a rank never
imports JAX; the tests compare against the JAX package in the parent."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import smoke_variant
from repro_torch.core import collectives as C
from repro_torch.core import pipeline as PL
from repro_torch.core.context import Access, Context, MemoryBank
from repro_torch.core.treereduce import Add, Max
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as PP
from repro_torch.models import registry
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import checkpoint as CK
from repro_torch.train import data as D
from repro_torch.train import fault as F
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_loop as TL


def _np(tree):
    """Full logical arrays of a tree (DTensors gathered) as numpy."""
    def one(_, t):
        if SH.is_dtensor(t):
            t = t.full_tensor()
        return t.detach().cpu().numpy().copy()
    return tree_map(one, tree)


# --- collectives, GPipe, MemoryBank.sharded (8 ranks) ---------------------------


def collectives(rank, world):
    out = {}
    x = (torch.arange(16, dtype=torch.float32) * (rank + 1)
         + (-1) ** rank * 7.0)                       # integer-valued fp32
    for name, op, red in (("add", Add, dist.ReduceOp.SUM),
                          ("max", Max, dist.ReduceOp.MAX)):
        want = x.clone()
        dist.all_reduce(want, op=red)
        out[f"want_{name}"] = want.numpy()
        out[f"tree_{name}"] = C.tree_all_reduce(x, None, op).numpy()
        out[f"ring_{name}"] = C.ring_all_reduce(x, None, op).numpy()
        out[f"lat_{name}"] = C.latency_optimal_all_reduce(x, None, op).numpy()
    # the reference's round trip: rank r holds row r of an (8, 8) table.
    table = torch.arange(world * 8, dtype=torch.float32).reshape(world, 8)
    out["rs"] = C.ring_reduce_scatter(table[rank], None).numpy()
    out["ag"] = C.ring_all_gather(torch.tensor([float(rank)]), None).numpy()
    # a mesh axis's group: tree all-reduce over "data" of a (4, 2) mesh.
    mesh = make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
    out["mesh_tree"] = C.tree_all_reduce(
        torch.full((3,), float(rank)), mesh.get_group("data")).numpy()
    # ppermute's gradient takes the reverse hop.
    v = torch.full((4,), float(rank), requires_grad=True)
    y = C.ppermute(v, None, [(r, (r + 1) % world) for r in range(world)])
    (y * (rank + 1.0)).sum().backward()
    out["hop"] = y.detach().numpy()
    out["hop_grad"] = v.grad.numpy()
    return out


def gpipe(rank, world):
    """GPipe over the "stage" axis of a (2, 4) mesh: two pipelines of 4."""
    mesh = make_host_mesh((2, 4), ("data", "stage"), device_type="cpu")
    group = mesh.get_group("stage")
    xs = torch.arange(24., dtype=torch.float32).reshape(6, 4)
    ys = PL.gpipe_pipeline(lambda p, x: x * p[0],
                           torch.arange(1., 5.)[:, None], xs, group)
    params = torch.tensor([[1.0], [0.5], [2.0], [1.5]])
    loss, grads = PL.gpipe_train_step(
        lambda p, x: torch.tanh(x * p[0]),
        lambda ys, t: torch.mean((ys - t) ** 2), params, xs / 10.0,
        torch.ones(6, 4), group)
    return {"ys": ys.numpy(), "loss": float(loss), "grads": grads.numpy()}


def memory_bank(rank, world):
    mesh = make_host_mesh((world,), ("data",), device_type="cpu")
    ctx = Context(mesh=mesh)
    data = np.arange(world * 2 * 3, dtype=np.float32).reshape(world * 2, 3)
    buf = ctx.MakeBuffer(torch.float32, Access.read_write,
                         MemoryBank.sharded("data"), data)
    rep = ctx.MakeBuffer(torch.float32, Access.read, MemoryBank.bank0, data)
    out = {"local": buf.tensor.to_local().numpy().copy(),
           "placements": str(buf.tensor.placements),
           "host": buf.CopyToHost(),
           "rep_local": rep.tensor.to_local().numpy().copy()}
    buf.CopyFromHost(data * 2)
    out["local2"] = buf.tensor.to_local().numpy().copy()
    out["placements2"] = str(buf.tensor.placements)
    return out


def rank_work_8(rank, world):
    return {"collectives": collectives(rank, world),
            "gpipe": gpipe(rank, world),
            "bank": memory_bank(rank, world)}


# --- sharded training -----------------------------------------------------------


def _batch(cfg, gb=8, seq=16, step=0):
    return {k: torch.from_numpy(v) for k, v in D.make_batch(
        cfg, D.DataCfg(global_batch=gb, seq_len=seq), step).items()}


def sharded_step(mesh, arch, params_np, tcfg):
    """One sharded step of ``arch`` (smoke) from numpy weights: its loss,
    grad norm, parameters and moments (numpy), the placements, and the
    state."""
    cfg = smoke_variant(configs.get(arch))
    fn, (psh, osh), _ = TL.make_train_step(cfg, tcfg, mesh)
    params = SH.place_tree(PP.params_from_numpy(params_np, "cpu"), psh)
    p2, o2, m = fn(params, OPT.init(params, osh.m), _batch(cfg))
    return ({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "params": _np(p2), "m": _np(o2.m), "v": _np(o2.v),
             "m_placements": sorted({str(x.placements)
                                     for x in tree_leaves(o2.m)})},
            (p2, o2, psh, osh))


def train_mesh42(rank, world, params_np, ckpt_dir):
    """minitron on (4, 2), no compression; then the state is saved for
    the elastic restart."""
    mesh = make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
    res, (p, o, psh, _) = sharded_step(
        mesh, "minitron-4b", params_np["minitron-4b"],
        TL.TrainCfg(compress_grads=False))
    # a global batch of 6 does not split over "data" (4): refused before
    # anything runs, as the reference's batch sharding refuses it.
    cfg = smoke_variant(configs.get("minitron-4b"))
    fn6 = TL.make_train_step(cfg, TL.TrainCfg(compress_grads=False), mesh)[0]
    try:
        fn6(p, o, _batch(cfg, gb=6))
        res["batch6"] = None
    except ValueError as e:
        res["batch6"] = str(e)
    res["param_specs"] = tree_map(lambda _, sh: tuple(sh.spec), psh)
    res["param_placements"] = tree_map(lambda _, x: str(x.placements), p)
    CK.save(ckpt_dir, 1, {"params": p, "opt": o})
    return res


def train_mesh22(rank, world, params_np):
    """minitron with ZeRO-1, with bf16 gradient reduction and with two
    microbatches; phi3.5-moe and mamba2: each one step on (2, 2)."""
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    mini = params_np["minitron-4b"]
    out["zero1"], _ = sharded_step(
        mesh, "minitron-4b", mini,
        TL.TrainCfg(compress_grads=False, zero1=True))
    out["compress"], _ = sharded_step(mesh, "minitron-4b", mini,
                                      TL.TrainCfg(compress_grads=True))
    out["accum"], _ = sharded_step(
        mesh, "minitron-4b", mini,
        TL.TrainCfg(compress_grads=False, grad_accum=2))
    out["update"] = zero1_update(mesh, params_np["minitron-4b"])
    for arch in ("phi3p5-moe-42b", "mamba2-1p3b"):
        out[arch], _ = sharded_step(mesh, arch, params_np[arch],
                                    TL.TrainCfg(compress_grads=False))
    return out


def zero1_update(mesh, params_np):
    """``optimizer.update`` alone with ZeRO-1 moments on ``mesh``, from
    seeded gradients and moments: the parameters and moments after it,
    gathered, to hold against the one-process ``update``."""
    cfg = smoke_variant(configs.get("minitron-4b"))
    _, (psh, osh), _ = TL.make_train_step(cfg, TL.TrainCfg(zero1=True), mesh)
    plain = PP.params_from_numpy(params_np, "cpu")
    gen = torch.Generator().manual_seed(5)

    def draw(scale):
        return tree_map(lambda _, p: torch.randn(p.shape, generator=gen)
                        * scale, plain)
    grads, m = draw(1e-2), draw(1e-3)
    v = tree_map(lambda _, t: t.abs(), draw(1e-3))
    state = OPT.OptState(torch.tensor(3, dtype=torch.int32),
                         SH.place_tree(m, osh.m), SH.place_tree(v, osh.v))
    params = SH.place_tree(plain, psh)
    g = SH.place_tree(grads, psh)
    cfg_opt = OPT.OptCfg(warmup_steps=2, total_steps=10)
    p2, o2, met = OPT.update(cfg_opt, g, state, params)
    return {"params": _np(p2), "m": _np(o2.m), "v": _np(o2.v),
            "grad_norm": float(met["grad_norm"]),
            "m_placements": sorted({str(x.placements)
                                    for x in tree_leaves(o2.m)})}


def train_elastic(rank, world, ckpt_dir):
    """The restart after losing half the ranks: a (2, 2) mesh from the
    survivors, the checkpoint of the (4, 2) run restored onto it (the
    moments with ``shardings=``, the parameters re-placed by
    ``reshard_state``), then one more step."""
    cfg = smoke_variant(configs.get("minitron-4b"))
    mesh = F.elastic_mesh(("data", "model"), model_axis=2,
                          device_type="cpu")
    tcfg = TL.TrainCfg(compress_grads=False)
    fn, (psh, osh), _ = TL.make_train_step(cfg, tcfg, mesh)
    shapes = registry.init(cfg, 0, device="cpu")
    like = {"params": shapes, "opt": OPT.init(shapes)}
    state, step, _ = CK.restore(ckpt_dir, like,
                                shardings={"params": None, "opt": osh})
    params = F.reshard_state(state["params"], registry.specs(cfg, mesh),
                             mesh)
    p2, o2, m = fn(params, state["opt"], _batch(cfg, step=step))
    return {"mesh": dict(SH.mesh_shape(mesh)), "step": step,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _np(p2)}


def train_matrix(rank, world, params_np):
    """One step of each arch in ``params_np`` on (2, 2)."""
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    return {arch: sharded_step(mesh, arch, w,
                               TL.TrainCfg(compress_grads=False))[0]
            for arch, w in params_np.items()}
