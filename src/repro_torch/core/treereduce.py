"""F7 — TreeReduce with functors (paper §III-D); port of ``core/treereduce.py``.

The paper: a fully pipelined reduction under an associative operator
should be a *balanced binary tree*, but accumulation loops rely on the
compiler noticing (and on permission to reorder non-associative FP ops).
hlslib's ``TreeReduce`` instantiates the tree explicitly, for any type,
size and binary operator given as a functor (``Apply`` + identity).

PyTorch makes no ordering promise for ``sum`` either, so this module gives
the same explicit guarantee as the JAX package:

* functor classes with ``apply`` + ``identity`` (Add/Mul/Max/Min/
  LogSumExp and user-defined);
* ``tree_reduce`` — a balanced pairwise tree over a static axis length:
  depth ⌈log2 N⌉, element ``i`` combines with ``i + half`` at every level,
  so the grouping (and every bit of a float result) is the reference's;
* ``serial_reduce`` — the accumulation-loop baseline;
* ``tree_reduce_fn`` — the same tree over a Python list of tensors (or of
  nested dicts/lists/tuples of tensors).

``kernels/treereduce_kernel.py`` (kernel B7) runs the same halving on the
card, one CTA per row.
"""

from __future__ import annotations

import math
from typing import Any, Protocol

import torch


class Functor(Protocol):
    identity: Any
    @staticmethod
    def apply(a, b): ...


class Add:
    identity = 0.0
    @staticmethod
    def apply(a, b):
        return a + b


class Mul:
    identity = 1.0
    @staticmethod
    def apply(a, b):
        return a * b


class Max:
    identity = -math.inf
    @staticmethod
    def apply(a, b):
        return torch.maximum(a, b)


class Min:
    identity = math.inf
    @staticmethod
    def apply(a, b):
        return torch.minimum(a, b)


class LogSumExp:
    """Numerically stable streaming logsumexp combiner — the functor the
    online-softmax attention kernels use to merge per-block partials."""
    identity = -math.inf
    @staticmethod
    def apply(a, b):
        m = torch.maximum(a, b)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def tree_reduce(x: torch.Tensor, op: type[Functor] = Add, axis: int = -1
                ) -> torch.Tensor:
    """Explicitly balanced binary tree reduction along ``axis``.

    The axis is padded to a power of two with the operator identity (the
    tree stays balanced; identity legs are no-ops), then halved until one
    element is left: ``x[i] = op(x[i], x[i + half])``.  Matches
    ``hlslib::TreeReduce<T, Op, N>`` and the JAX package bit for bit.
    """
    x = torch.movedim(x, axis % x.dim(), -1)
    n = x.shape[-1]
    if n == 0:
        raise ValueError("cannot tree-reduce an empty axis")
    p = 1 << (n - 1).bit_length()
    if p != n:
        pad = torch.full(x.shape[:-1] + (p - n,), op.identity,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = op.apply(x[..., :half], x[..., half:])
    return x[..., 0]


def serial_reduce(x: torch.Tensor, op: type[Functor] = Add, axis: int = -1
                  ) -> torch.Tensor:
    """Left-to-right fold — the accumulation-loop baseline the paper warns
    about.  Kept for tests contrasting accuracy and depth."""
    x = torch.movedim(x, axis % x.dim(), 0)
    acc = torch.full(x.shape[1:], op.identity, dtype=x.dtype, device=x.device)
    for xi in x:
        acc = op.apply(acc, xi)
    return acc


def _tree_map(fn, a, b):
    """``fn`` leaf by leaf over two equally nested dicts/lists/tuples."""
    if isinstance(a, dict):
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def tree_reduce_fn(xs: list, op: type[Functor] = Add):
    """Tree-reduce a Python list of tensors (or of nested dicts/lists/
    tuples of tensors): neighbours pair up level by level, an odd last
    element passes up unchanged."""
    if not xs:
        raise ValueError("empty list")
    layer = list(xs)
    while len(layer) > 1:
        nxt = [_tree_map(op.apply, layer[i], layer[i + 1])
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]
