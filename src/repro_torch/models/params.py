"""Declarative parameter trees (port of ``models/params.py``).

Model code declares each tensor once as a ``Decl`` (shape + logical axes
+ init); ``init_params`` turns a tree of them into tensors.  Trees are
plain nested dicts, as in the JAX package, so a parameter tree of either
package has the same paths and the same shapes.

``param_specs`` turns the same tree into sharding specs through the
logical-axis rules (``distributed/sharding.py``).

``params_from_numpy`` carries weights across: it takes the JAX package's
parameters as nested dicts of numpy arrays (``np.asarray`` of each leaf)
and returns the port's tensors, bit for bit; ``opt_state_from_numpy``
does the same for the reference's optimizer state.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Decl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"       # normal | zeros | ones
    std: Optional[float] = None  # override stddev for normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank "
                             "mismatch")


def stack_one(d: Decl, n: int) -> Decl:
    """Prepend a length-n "stack" axis (the per-layer leading axis)."""
    return Decl((n,) + d.shape, ("stack",) + d.axes, d.dtype, d.init, d.std)


def tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """Map ``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def tree_at(tree, path: Tuple[str, ...]):
    """The node of a nested dict at ``path`` (as ``tree_map`` gives it)."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def stack_decls(tree, n: int):
    return tree_map(lambda _, d: stack_one(d, n), tree)


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) >= 2:
        return shape[-2]
    return shape[-1]


def init_params(decls, seed: int = 0, *, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Deterministic init: every leaf's generator is seeded from its tree
    path (the reference's sha256 rule), so adding or removing parameters
    never reshuffles the others.  Values are drawn directly on ``device``
    in the leaf's dtype — or in ``dtype``, which overrides every floating
    leaf (full-width bf16 weights never pass through an fp32 copy).

    The draws are torch's, not JAX's: the two packages give different
    weights from one seed; tests carry JAX weights over with
    ``params_from_numpy`` instead."""

    def leaf(path, d: Decl):
        dt = dtype if (dtype is not None and d.dtype.is_floating_point) \
            else d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        h = int.from_bytes(
            hashlib.sha256(f"{seed}:{'/'.join(path)}".encode()).digest()[:8],
            "little")
        gen = torch.Generator(device=device)
        gen.manual_seed(h % (2 ** 63))
        std = d.std if d.std is not None else 1.0 / np.sqrt(_fan_in(d.shape))
        x = torch.randn(d.shape, generator=gen, dtype=dt, device=device)
        return x.mul_(std)

    return tree_map(leaf, decls)


def abstract_tensor(shape, dtype: torch.dtype, fake_mode=None):
    """A tensor without storage (the reference's ``ShapeDtypeStruct``): a
    fake CPU tensor made in ``fake_mode`` (a ``FakeTensorMode``; ops on
    it run through the CPU code paths and allocate nothing), or a
    ``meta`` tensor when it is None."""
    if fake_mode is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    with fake_mode:
        return torch.empty(shape, dtype=dtype, device="cpu")


def abstract_params(decls, fake_mode=None,
                    dtype: Optional[torch.dtype] = None):
    """The tree of ``decls`` as tensors without storage
    (``abstract_tensor``).  ``dtype`` overrides every floating leaf, as in
    ``init_params``."""
    def leaf(_, d: Decl):
        dt = dtype if (dtype is not None and d.dtype.is_floating_point) \
            else d.dtype
        return abstract_tensor(d.shape, dt, fake_mode)
    return tree_map(leaf, decls)


def param_specs(decls, mesh=None):
    """Specs from logical axes with shape-aware assignment
    (``distributed.sharding.spec_for``): a mesh axis that does not divide
    its dimension is skipped without being consumed (40 kv heads can't
    take 'model', which then falls through to a later dim).  ``mesh`` is
    a ``DeviceMesh`` or a mesh shape ({axis: size}); no mesh gives specs
    of ``None`` entries only."""
    from ..distributed.sharding import spec_for
    return tree_map(lambda _, d: spec_for(d.axes, mesh, d.shape), decls)


def param_count(decls) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(decls))


def cast_tree(params, dtype: torch.dtype):
    return tree_map(
        lambda _, p: p.to(dtype) if p.dtype.is_floating_point else p, params)


_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def _leaf_from_numpy(a, device, dtype):
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:          # e.g. a view of a JAX buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in numpy's eyes:
        # carry the bits (uint16 -> int16) and view them as bfloat16.
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    elif a.dtype in _NUMPY_TO_TORCH:
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"params_from_numpy: unsupported dtype {a.dtype}")
    t = t.to(device)
    if dtype is not None and t.dtype.is_floating_point:
        t = t.to(dtype)
    return t


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device``.  ``dtype`` (optional) recasts every floating leaf."""
    return tree_map(lambda _, a: _leaf_from_numpy(a, device, dtype), tree)


def opt_state_from_numpy(step, m, v, device):
    """The JAX package's ``OptState`` (``step`` an int or 0-d array; ``m``,
    ``v`` nested dicts of numpy arrays, ``np.asarray`` of each leaf) ->
    the port's ``train.optimizer.OptState`` on ``device``, bit for bit:
    a run the reference began can go on in the port."""
    from ..train.optimizer import OptState
    return OptState(step=torch.tensor(int(np.asarray(step)),
                                      dtype=torch.int32),
                    m=params_from_numpy(m, device),
                    v=params_from_numpy(v, device))
