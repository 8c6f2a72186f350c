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

Not ported yet: the mesh (sharded parameters, the data-parallel
all-reduce and ZeRO-1) waits for the tensor-parallel port, and
``abstract_opt_state`` for the dry-run port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import registry
from ..models.params import tree_leaves, tree_map
from . import optimizer as opt

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    opt: opt.OptCfg = dataclasses.field(default_factory=opt.OptCfg)
    grad_accum: int = 1             # microbatches per step
    compress_grads: bool = True     # round the gradients through bf16
    zero1: bool = False             # shard the moments (needs a mesh)


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the *logical* vocab: padded-vocab logits are masked
    to the float32 minimum before the logsumexp, so the padding takes no
    probability mass.  logits (..., Vp), labels (...)."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    lf = logits.to(F32)
    if Vp != V:
        mask = torch.arange(Vp, device=lf.device) < V
        lf = torch.where(mask, lf, lf.new_tensor(torch.finfo(F32).min))
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


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


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, gradients as a tree like ``params``, each in its
    parameter's dtype)."""
    with torch.enable_grad():
        live = tree_map(lambda _, p: p.detach().requires_grad_(), params)
        loss, _ = loss_fn(cfg, live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _, __: next(it), live)


def make_train_step(cfg: ModelConfig, tcfg: TrainCfg = TrainCfg(),
                    mesh=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``grad_norm`` (0-d device tensors) and ``lr``.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    sums their gradients in fp32 before dividing, as the reference's
    scan does; ``compress_grads`` rounds the gradients through bf16
    before the update.  ``use_pallas`` on the recurrent families is
    refused: kernel B6 has no backward (nor has the reference's Pallas
    scan)."""
    if mesh is not None:
        raise NotImplementedError(
            "train on a mesh: sharded training waits for the tensor-parallel "
            "port (A13)")
    if cfg.use_pallas and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: use_pallas routes the SSD scan through kernel B6, "
            "which has no backward (nor does the reference's Pallas scan); "
            "train with use_pallas=False")

    def step(params, opt_state, batch):
        if tcfg.grad_accum > 1:
            grads, losses = None, []
            for mb in _split_micro(batch, tcfg.grad_accum):
                loss_i, g = value_and_grad(cfg, params, mb)
                losses.append(loss_i)
                if grads is None:
                    grads = tree_map(lambda _, a: torch.zeros(
                        a.shape, dtype=F32, device=a.device), g)
                for acc, a in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(a.to(F32))
                del g
            for acc in tree_leaves(grads):
                acc.div_(tcfg.grad_accum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = value_and_grad(cfg, params, batch)
        if tcfg.compress_grads:
            grads = tree_map(lambda _, g: g.to(torch.bfloat16), grads)
        params, opt_state, metrics = opt.update(tcfg.opt, grads, opt_state,
                                                params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
