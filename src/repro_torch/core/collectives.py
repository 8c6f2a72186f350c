"""F7 at mesh level — explicit tree/ring collective schedules (port of
``core/collectives.py``) on ``torch.distributed``.

The distributed analogue of ``TreeReduce``: instead of trusting the
backend's collective algorithm, build the reduction tree (or the
bandwidth-optimal ring) explicitly from one primitive, ``ppermute``:
every rank of a process group sends its tensor along a permutation of
the group's ranks, as ``jax.lax.ppermute`` does inside ``shard_map``.

* ring reduce-scatter + all-gather is bandwidth-optimal for large
  tensors; recursive doubling is latency-optimal for small ones, and
  ``latency_optimal_all_reduce`` picks per tensor (1 MiB switch);
* every hop is a ``batch_isend_irecv`` of known bytes, so the schedule's
  traffic is countable.

A ``group`` is a ``torch.distributed`` process group (``None``: the
default group); a mesh axis's group is ``mesh.get_group(name)``.  Every
rank of the group calls each function with tensors of one shape.
``ppermute`` is differentiable: its backward is the reverse hop, as
``jax.grad`` transposes a ``ppermute``; the schedules built on it are
differentiable with it.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .treereduce import Add, Functor


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    return dist.get_rank(group)


def _hop(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
         ) -> torch.Tensor:
    """Send ``x`` from each source to its destination (group ranks); a
    rank that receives nothing gets zeros."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst)
                                  if group is not None else dst, group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src)
                                  if group is not None else src, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _hop(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        back = tuple((dst, src) for src, dst in ctx.perm)
        return ppermute(g, ctx.group, back), None, None


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``x`` of rank ``src`` arrives at rank ``dst`` for every ``(src,
    dst)`` of ``perm`` (ranks of ``group``; each rank sends at most once
    and receives at most once); a rank that receives nothing gets zeros.
    Differentiable: the gradient takes the reverse hop."""
    return _PPermute.apply(x, group, tuple((int(s), int(d)) for s, d in perm))


def tree_all_reduce(x: torch.Tensor, group=None,
                    op: type[Functor] = Add) -> torch.Tensor:
    """Balanced-tree all-reduce via recursive doubling (latency-optimal:
    ⌈log2 P⌉ steps, each moving |x| bytes).

    Step k exchanges with the partner at XOR distance 2^k — a butterfly —
    so every rank ends with the full reduction without a broadcast phase.
    The group size must be a power of two."""
    p = axis_size(group)
    if p & (p - 1):
        raise ValueError(f"tree_all_reduce requires power-of-two axis, got {p}")
    for k in range(int(math.log2(p))):
        d = 1 << k
        other = ppermute(x, group, [(i, i ^ d) for i in range(p)])
        x = op.apply(x, other)
    return x


def ring_reduce_scatter(x: torch.Tensor, group=None,
                        op: type[Functor] = Add) -> torch.Tensor:
    """Bandwidth-optimal ring reduce-scatter: P-1 steps, each moving
    |x|/P bytes.  Returns this rank's reduced shard (axis 0 split)."""
    p, i = axis_size(group), axis_index(group)
    n = x.shape[0]
    if n % p:
        raise ValueError(f"leading dim {n} not divisible by axis size {p}")
    xs = x.reshape((p, n // p) + tuple(x.shape[1:]))
    perm = [(r, (r + 1) % p) for r in range(p)]
    # Rank i seeds the ring with its copy of chunk (i-1).  The chunk that
    # arrives at rank i at step s left rank i-s carrying chunk (i-s-1),
    # so rank i adds its xs[i-s-1]; after P-1 steps rank i holds every
    # rank's contribution to chunk i.
    acc = xs[(i - 1) % p]
    for step in range(1, p):
        acc = ppermute(acc, group, perm)
        acc = op.apply(acc, xs[(i - 1 - step) % p])
    return acc


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-gather: P-1 steps each moving |x| bytes; the ranks'
    tensors stacked along a new leading axis in rank order."""
    p, i = axis_size(group), axis_index(group)
    perm = [(r, (r + 1) % p) for r in range(p)]
    pieces = [x]
    cur = x
    for _ in range(p - 1):
        cur = ppermute(cur, group, perm)
        pieces.append(cur)
    # piece k came from rank i - k: rank j's tensor is piece (i - j) % p.
    return torch.stack([pieces[(i - j) % p] for j in range(p)])


def ring_all_reduce(x: torch.Tensor, group=None,
                    op: type[Functor] = Add) -> torch.Tensor:
    """reduce-scatter + all-gather ring all-reduce (bandwidth-optimal:
    2(P-1)/P · |x| bytes per link)."""
    shard = ring_reduce_scatter(x, group, op)
    return ring_all_gather(shard, group).reshape(x.shape)


def latency_optimal_all_reduce(x: torch.Tensor, group=None,
                               op: type[Functor] = Add,
                               small_bytes: int = 1 << 20) -> torch.Tensor:
    """Per-tensor schedule choice: tree for small tensors (log P latency),
    ring for large ones (bandwidth-optimal) when the leading dim splits
    over the group."""
    nbytes = x.numel() * x.element_size()
    if nbytes <= small_bytes and x.dim() >= 1:
        return tree_all_reduce(x, group, op)
    if x.shape[0] % axis_size(group) == 0:
        return ring_all_reduce(x, group, op)
    return tree_all_reduce(x, group, op)

