"""The train step (port of ``train/train_loop.py``): loss, gradients,
microbatch accumulation, bf16 gradient compression and the AdamW update.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``.  The step updates ``params`` and the moments in
place and returns them (the reference's jitted step donates both), so
a caller that needs the old values keeps a copy.  Gradients are taken
with ``torch.autograd.grad`` against detached views of the parameters:
no ``.grad`` is left on them.  The forward runs in ``mode="train"``:
attention through ``layers.attention_blocked``, every layer under
``cfg.remat``.

On a ``DeviceMesh`` the same step runs on DTensors: parameters placed
by ``params.param_specs``, moments by ``optimizer.opt_specs`` (ZeRO-1
with ``zero1``), the batch's rows over (pod, data); the model's
``constrain`` points redistribute the activations, and the code without
a DTensor rule runs on local shards (``sharding.local_region``).

``abstract_opt_state`` gives the dry-run the optimizer state without
storage.

With a ``core.trace.Tracer`` (``tracer=``) each step is the host span
``train.step`` holding ``train.forward`` (``loss_fn``),
``train.backward`` (``torch.autograd.grad``; both once per microbatch)
and ``train.optimizer`` (``optimizer.update``); with the tracer's
``profile`` each is a ``torch.profiler`` range.  The step returns
before the device finishes, so its span ends with the launches; without
a tracer the step reads no clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed import sharding as SH
from ..models import params as PP
from ..models import registry
from ..models.params import abstract_tensor, tree_at, tree_leaves, tree_map
from . import optimizer as opt

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    opt: opt.OptCfg = dataclasses.field(default_factory=opt.OptCfg)
    grad_accum: int = 1             # microbatches per step
    compress_grads: bool = True     # round the gradients through bf16
    zero1: bool = False             # shard the moments over "data"


def abstract_opt_state(ab_params, fake_mode=None) -> opt.OptState:
    """The optimizer state of ``ab_params`` without storage: fp32 moments
    like each leaf (fake tensors made in ``fake_mode``, else ``meta``)
    and the host step count 0, made in ``fake_mode`` too, where the step
    reads it back as a constant."""
    def moment(_, a):
        return abstract_tensor(a.shape, F32, fake_mode)
    with fake_mode or contextlib.nullcontext():
        step = torch.tensor(0, dtype=torch.int32)
    return opt.OptState(step=step, m=tree_map(moment, ab_params),
                        v=tree_map(moment, ab_params))


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the *logical* vocab: padded-vocab logits are masked
    to the float32 minimum before the logsumexp, so the padding takes no
    probability mass.  logits (..., Vp), labels (...)."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab

    def nll(logits, labels):
        lf = logits.to(F32)
        if Vp != V:
            mask = torch.arange(Vp, device=lf.device) < V
            lf = torch.where(mask, lf, lf.new_tensor(torch.finfo(F32).min))
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return logz - gold

    # on a mesh: every row's whole vocab on its shard (the padded-vocab
    # mask, logsumexp and gather have no vocab-sharded rule).
    rows = ("batch",) + (None,) * (labels.dim() - 1)
    return torch.mean(SH.local_region(nll, (logits, labels),
                                   (rows + (None,), rows), (1,)))


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token loss of a batch (labels pre-shifted by the data
    pipeline); vlm: over the text positions only, after the patches."""
    logits = registry.forward(cfg, params, batch, mode="train")
    if cfg.family == "vlm":
        logits = logits[:, cfg.vision_patches:]
    loss = cross_entropy(cfg, logits, batch["labels"])
    return loss, {"loss": loss}


def _split_micro(batch, n: int):
    """Each leaf (b, ...) -> n microbatches of (b // n, ...)."""
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} % grad_accum {n} != 0")
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def value_and_grad(cfg: ModelConfig, params, batch, tracer=None):
    """(loss, gradients as a tree like ``params``, each in its
    parameter's dtype); with ``tracer`` the forward and the backward
    are the spans ``train.forward`` and ``train.backward``."""
    with torch.enable_grad():
        live = tree_map(lambda _, p: p.detach().requires_grad_(), params)
        fwd = tracer.open("train.forward") if tracer is not None else None
        loss, _ = loss_fn(cfg, live, batch)
        leaves = tree_leaves(live)
        if tracer is not None:
            bwd = tracer.open("train.backward", at=fwd.close())
        grads = torch.autograd.grad(loss, leaves)
        if tracer is not None:
            bwd.close()
    it = iter(grads)
    return loss.detach(), tree_map(lambda _, __: next(it), live)


def _batch_sharding(mesh, x) -> "SH.Sharding":
    """A batch leaf's sharding: rows over the batch axes (pod, data)."""
    return SH.Sharding(mesh, SH.spec_for(
        ("batch",) + (None,) * (x.dim() - 1), mesh, tuple(x.shape)))


def make_train_step(cfg: ModelConfig, tcfg: TrainCfg = TrainCfg(),
                    mesh=None, tracer=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``grad_norm`` (0-d device tensors) and ``lr``.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    sums their gradients in fp32 before dividing, as the reference's
    scan does; ``compress_grads`` rounds the gradients through bf16
    before the update.  ``use_pallas`` on the recurrent families is
    refused: kernel B6 has no backward (nor has the reference's Pallas
    scan).

    With no mesh this returns the step alone.  With a ``DeviceMesh`` it
    returns ``(step, (param shardings, opt shardings), (abstract params,
    opt specs))`` as the reference does: the step takes parameters and
    moments as DTensors placed by those shardings (``param_specs``;
    ``opt_specs``, ZeRO-1 with ``zero1``) and the global batch, plain
    (the same on every rank) or as DTensors; its rows are sharded over
    (pod, data).  The loss and the gradients run on DTensors (the
    model's ``constrain`` points redistribute the activations); the
    gradients are reduced to their parameters' placements — in bf16 with
    ``compress_grads``, so the data-axis reduction moves half the bytes
    — and ``optimizer.update`` updates the local shards.  Metrics are
    plain tensors.  ``tracer`` (a ``core.trace.Tracer``) takes each
    step's host spans, owned by the step's ordinal in this function."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh: a torch DeviceMesh, got {type(mesh)}")
    if cfg.use_pallas and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: use_pallas routes the SSD scan through kernel B6, "
            "which has no backward (nor does the reference's Pallas scan); "
            "train with use_pallas=False")

    def place_batch(batch):
        if mesh is None:
            return batch
        n = 1
        for a in SH.spec_axes(SH.spec_for(("batch",), mesh)[0]):
            n *= SH.mesh_shape(mesh)[a]
        for k, v in batch.items():
            if v.shape[0] % n:
                # as the reference's batch in_sharding: DTensor would
                # shard such rows unevenly inside the step, where its
                # reshapes refuse them.
                raise ValueError(
                    f"batch[{k!r}]: {v.shape[0]} rows do not split over the "
                    f"batch axes of the mesh ({n} shards)")
        return {k: _batch_sharding(mesh, v).place(v) for k, v in batch.items()}

    taken = [0]

    def step(params, opt_state, batch):
        if tracer is None:
            return body(params, opt_state, batch)
        taken[0] += 1
        with tracer.open("train.step", owner=taken[0] - 1,
                         number=taken[0] - 1):
            return body(params, opt_state, batch)

    def body(params, opt_state, batch):
        if tcfg.grad_accum > 1:
            if mesh is not None:
                batch = {k: v.full_tensor() if SH.is_dtensor(v) else v
                         for k, v in batch.items()}
            grads, losses = None, []
            for mb in _split_micro(batch, tcfg.grad_accum):
                loss_i, g = value_and_grad(cfg, params, place_batch(mb),
                                           tracer)
                losses.append(loss_i)
                if grads is None:
                    grads = tree_map(
                        lambda _, a: torch.zeros_like(a, dtype=F32), g)
                for acc, a in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(a.to(F32))
                del g
            for acc in tree_leaves(grads):
                acc.div_(tcfg.grad_accum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = value_and_grad(cfg, params, place_batch(batch),
                                         tracer)
        if tcfg.compress_grads:
            grads = tree_map(lambda _, g: g.to(torch.bfloat16), grads)
        if mesh is not None:
            # the data-axis (and model-axis partial) reduction, to each
            # parameter's placements.
            grads = tree_map(lambda path, g: g.redistribute(
                mesh, tree_at(params, path).placements), grads)
            loss = loss.full_tensor()
        upd = tracer.open("train.optimizer") if tracer is not None else None
        params, opt_state, metrics = opt.update(tcfg.opt, grads, opt_state,
                                                params)
        if upd is not None:
            upd.close()
        metrics["loss"] = loss
        return params, opt_state, metrics

    if mesh is None:
        return step
    decls = registry.decls(cfg)
    p_specs = PP.param_specs(decls, mesh)
    o_specs = opt.opt_specs(p_specs, decls, mesh, tcfg.zero1)

    def shard(_, spec):
        return SH.Sharding(mesh, spec)
    shardings = (tree_map(shard, p_specs),
                 opt.OptState(step=None, m=tree_map(shard, o_specs.m),
                              v=tree_map(shard, o_specs.v)))
    return step, shardings, (PP.abstract_params(decls), o_specs)
