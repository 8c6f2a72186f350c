"""AdamW with a cosine schedule and global-norm clipping (port of
``train/optimizer.py``).

Plain PyTorch, no ``torch.optim``, so the state is the reference's
``OptState(step, m, v)`` and checkpoints hold the same leaves.  Moments
and the update are fp32; a parameter keeps its own dtype.  ``update``
works leaf by leaf, in place, in slices of at most ``CHUNK`` elements:
the fp32 temporaries of the update never exceed a few slices, whatever
the size of the model (no second fp32 copy of it).

The step count lives on the host (a 0-d int32 CPU tensor): the schedule
and the bias corrections are host scalars computed in float32 as the
reference computes them, so a step reads nothing back from the device.
The clip factor stays on the device.  ``opt_specs`` (ZeRO-1 sharding of
the moments) waits for the tensor-parallel port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.treereduce import Add, tree_reduce_fn
from ..models.params import tree_map

F32 = torch.float32
# elements of one slice of a leaf in ``update`` and ``global_norm`` (fp32
# temporaries of 256 MB at most).
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor         # 0-d int32, on the host
    m: Any                     # tree like params, fp32
    v: Any


def sorted_leaves(tree):
    """The leaves of nested dicts, tuples and lists (``OptState`` too),
    dict keys in sorted order (the reference's ``jax.tree.leaves``
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in sorted_leaves(t)]
    return [tree]


def init(params) -> OptState:
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: OptCfg, step) -> float:
    """Learning rate at ``step`` (int or 0-d tensor): linear warmup, then
    cosine down to ``min_lr_frac``; float32 arithmetic, as the
    reference's."""
    f = np.float32
    s = int(step)
    if s < cfg.warmup_steps:
        return float(f(cfg.lr) * f(s + 1) / f(max(cfg.warmup_steps, 1)))
    t = np.clip(f(s - cfg.warmup_steps)
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f(0.0), f(1.0))
    c = np.cos(f(np.pi) * t)
    return float(f(cfg.lr) * (f(cfg.min_lr_frac) + f(
        (1 - cfg.min_lr_frac) * 0.5) * (f(1) + c)))


def _slices(t: torch.Tensor):
    """Flat views of a contiguous tensor, ``CHUNK`` elements at most (a
    view fails on a tensor that is not contiguous: writes through a copy
    would be lost)."""
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)] \
        or [flat]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares (fp32) of every leaf: one sum per leaf,
    leaves combined by ``tree_reduce_fn`` in the reference's order."""
    sq = []
    for g in sorted_leaves(tree):
        parts = [torch.sum(torch.square(c.to(F32)))
                 for c in _slices(g.contiguous())]
        sq.append(parts[0] if len(parts) == 1 else torch.stack(parts).sum())
    return torch.sqrt(tree_reduce_fn(sq, Add))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(norm.new_tensor(max_norm) / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda _, g: g.to(F32) * scale, grads), norm


def update(cfg: OptCfg, grads, state: OptState, params
           ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step, in place: ``params``, ``state.m`` and ``state.v``
    are written and returned with the next step count.  Gradients may be
    bf16 (compressed) or fp32; each is clipped by the global norm and the
    moments and the parameter update in fp32, slice by slice.  Metrics:
    ``grad_norm`` (a 0-d device tensor, before clipping) and ``lr``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    f = np.float32
    n = int(state.step) + 1
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = float(f(1) - f(b1) ** f(n)), float(f(1) - f(b2) ** f(n))
    leaves = zip(sorted_leaves(params), sorted_leaves(grads),
                 sorted_leaves(state.m), sorted_leaves(state.v))
    with torch.no_grad():
        for p, g, m, v in leaves:
            for ps, gs, ms, vs in zip(*map(_slices, (p, g.contiguous(), m,
                                                     v))):
                gf = gs.to(F32) * scale
                ms.mul_(b1).add_(gf * (1 - b1))
                vs.mul_(b2).add_(torch.square(gf) * (1 - b2))
                upd = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                pf = ps.to(F32)
                upd.add_(pf * cfg.weight_decay)
                ps.copy_(pf - lr * upd)
    step = torch.tensor(n, dtype=torch.int32)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
