"""Logical-axis sharding rules (port of ``distributed/sharding.py``, its
training half): the F1 "configuration over source edits" principle
applied to distribution.

Model code names *logical* axes ("batch", "heads", "ff", ...); a rule
table maps each to mesh axes.  The same model code then runs on one
device (plain tensors: every ``constrain`` is a no-op) or on a
``DeviceMesh`` (DTensors: ``constrain`` redistributes to the placements
the rules give), without touching model source.

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``,
a mesh-axis name, or a tuple of names (the reference's
``PartitionSpec``, whose ``tuple()`` it equals).  ``spec_for`` reckons
specs from a mesh *shape* — axis names and sizes, as a dict, or a
``DeviceMesh`` — so specs for a 16×16 mesh come out in one process
without a process group.  ``placements`` turns a spec into the DTensor
placements of a mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# batch over all data-parallel axes; model-parallel dims over "model".
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,           # sequence replicated by default ...
    "seq_sharded": ("data",),  # ... except SP mode (long-context)
    "embed": None,
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "moe_groups": ("pod", "data"),
    "kv_seq": ("model",),
    "d_inner": ("model",),
    "ssm_heads": ("model",),
    "state": None,
    "layers": None,
    "stack": None,
    "conv": None,
    "lora": None,
    "cond": None,
    "patches": None,
    "codebooks": None,
}

_rules_var: contextvars.ContextVar[Rules] = contextvars.ContextVar(
    "axis_rules", default=DEFAULT_RULES)


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, a mesh-axis
    name, or a tuple of them)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_rules() -> Rules:
    return _rules_var.get()


@contextlib.contextmanager
def use_rules(overrides: Optional[Rules] = None, **kw):
    """Rules with ``overrides`` (and keyword overrides) for the enclosed
    code."""
    rules = dict(_rules_var.get())
    rules.update(overrides or {})
    rules.update(kw)
    token = _rules_var.set(rules)
    try:
        yield rules
    finally:
        _rules_var.reset(token)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a mapping, or None (no
    mesh: {})."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def spec_for(axes: Sequence[Optional[str]], mesh=None,
             dims: Optional[Sequence[int]] = None) -> P:
    """Logical axes -> spec, filtered to the axes the mesh has.

    With ``dims`` (the tensor shape), a mesh axis that does not divide
    its dimension is skipped *without being consumed*, so a later
    logical axis can claim it (e.g. 40 kv heads can't take 'model', so
    the kv_seq dim gets it instead).  No mesh axis is used twice."""
    shape = mesh_shape(mesh)
    rules = axis_rules()
    parts = []
    used = set()
    for i, ax in enumerate(axes):
        target = None if ax is None else rules.get(ax, None)
        if target is None:
            parts.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        avail = []
        for t in target:
            if t not in shape or t in used:
                continue
            if dims is not None:
                prod = shape[t]
                for a in avail:
                    prod *= shape[a]
                if dims[i] % prod != 0:
                    continue
            avail.append(t)
        used.update(avail)
        parts.append(tuple(avail) if len(avail) > 1
                     else (avail[0] if avail else None))
    return P(*parts)


def spec_axes(part) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: Sequence, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    one per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh
    axis, else ``Replicate()``.  A mesh axis of size 1 replicates: its one
    shard is the whole dim either way, and DTensor cannot reshape a dim
    of size 1 sharded over it."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, part in enumerate(spec):
        for a in spec_axes(part):
            where[a] = d
    return [Shard(where[n]) if n in where and mesh.size(i) > 1
            else Replicate() for i, n in enumerate(mesh.mesh_dim_names)]


def constrain(x, *axes: Optional[str]):
    """Pin ``x`` to the placements of its logical ``axes``: a no-op on a
    plain tensor; a DTensor is redistributed to ``spec_for(axes, its
    mesh, its shape)`` (shape-aware, so no shard is uneven)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(spec_for(axes, x.device_mesh, tuple(x.shape)),
                      x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def zero_shard_spec(spec: Sequence, shape: Tuple[int, ...], mesh,
                    axis: str = "data") -> P:
    """ZeRO-1: additionally shard the first large, still-replicated dim of
    an optimizer-state tensor over the data axis (if divisible and the
    axis is free)."""
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        return P(*spec)
    n = sizes[axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(axis in spec_axes(p) for p in parts):
        return P(*parts)
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % n == 0 and d >= n:
            parts[i] = axis
            return P(*parts)
    return P(*spec)


def local_region(fn, args: Sequence, in_axes: Sequence, out_like: Sequence):
    """Run ``fn`` on the local shards of ``args`` (the reference's
    ``shard_map`` with logical axes) — for code that has no DTensor
    sharding rule: loops over tiles, masks built from ``arange``, index
    scatters.  Without a DTensor among ``args`` it is ``fn(*args)``.

    ``in_axes[i]`` names the logical axes ``args[i]`` is constrained to
    before its local shard is taken (``None``: taken as it is, or passed
    through if it is no tensor; a plain tensor is taken as replicated).
    ``fn`` returns a tensor or a tuple; output ``j`` is a DTensor sharded
    as input ``out_like[j]`` is, or, for an entry ``(i, dims)``, with
    input ``i``'s dim ``k`` sharding moved to output dim ``dims[k]``.
    ``fn`` must compute each output's local shard from the local shards
    alone.  The gradient of an input replicated over a mesh dim along
    which an output is sharded is a partial sum there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    placed = [constrain(a, *ax) if isinstance(a, DTensor) and ax is not None
              else a for a, ax in zip(args, in_axes)]

    def like(entry):
        i, dims = entry if isinstance(entry, tuple) else (entry, None)
        pls = list(placed[i].placements)
        if dims is None:
            return pls
        return [Shard(dims[p.dim]) if isinstance(p, Shard) else p
                for p in pls]

    outs_pl = [like(e) for e in out_like]
    sharded_out = {m for pl in outs_pl for m, p in enumerate(pl)
                   if isinstance(p, Shard)}
    locs = []
    for a in placed:
        if not isinstance(a, DTensor) or not a.is_floating_point():
            locs.append(a.to_local() if isinstance(a, DTensor) else a)
            continue
        grad_pl = [Partial() if isinstance(p, Replicate) and m in sharded_out
                   else p for m, p in enumerate(a.placements)]
        locs.append(a.to_local(grad_placements=grad_pl))
    outs = fn(*locs)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    res = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                for o, pl in zip(outs, outs_pl))
    return res[0] if single else res


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor):
        """``t`` as a DTensor of these placements: a DTensor is
        redistributed; a plain tensor, the whole logical array on every
        rank, is split where it lies (no communication)."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if isinstance(t, DTensor):
            if t.device_mesh == self.mesh and \
                    list(t.placements) == self.placements:
                return t
            t = t.full_tensor()
        return distribute_tensor(
            t.detach().to(self.mesh.device_type, copy=True), self.mesh,
            self.placements, src_data_rank=None)

    def zeros(self, shape, dtype: torch.dtype):
        """A DTensor of zeros of logical ``shape``, made shard by shard."""
        from torch.distributed.tensor import DTensor, Shard
        shape = list(shape)
        for n, part in enumerate(self.placements):
            if isinstance(part, Shard):
                shape[part.dim] //= self.mesh.size(n)
        local_t = torch.zeros(shape, dtype=dtype,
                              device=self.mesh.device_type)
        return DTensor.from_local(local_t, self.mesh, self.placements,
                                  run_check=False)


def place_tree(tree, shardings):
    """A tree of nested dicts placed leaf by leaf by the ``Sharding`` at
    the same path of ``shardings``."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.place(tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x
