"""Mesh factories (port of ``launch/mesh.py``): ``DeviceMesh`` builders.

Functions, not module-level constants: importing this module touches no
device and starts no process group.  Each builder expects the process
group to be up (``torch.distributed.init_process_group``) with as many
ranks as the mesh has devices; ``device_type`` is ``"cuda"`` (NCCL) by
default, ``"cpu"`` (gloo) when the caller asks, as the tests do.
``serving_mesh`` is the sharded serving path's mesh: rank-keyed axis
names whose last axis is the tensor-parallel one.
"""

from __future__ import annotations

from typing import Tuple


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device_type=device_type)


def make_host_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                   device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the ranks of the default
    process group, rank-major (the last axis varies fastest)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


SERVING_AXES = {1: ("model",), 2: ("data", "model"),
                3: ("pod", "data", "model")}


def serving_axes(shape: Tuple[int, ...], tp_axis: str = "model"
                 ) -> Tuple[str, ...]:
    """The axis names of a serving mesh of ``shape``, keyed by its rank so
    the LAST axis is always the tensor-parallel one (the rules' "heads",
    "kv_heads", "ff", ... -> "model").  Raises on an empty shape, a rank
    above 3, and a ``tp_axis`` that is not the last axis."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        raise ValueError("serving_mesh: empty mesh_shape")
    try:
        axes = SERVING_AXES[len(shape)]
    except KeyError:
        raise ValueError(
            f"serving_mesh: mesh_shape {shape} has rank {len(shape)}; "
            f"supported ranks are 1 (model,), 2 (data, model), "
            f"3 (pod, data, model)") from None
    if tp_axis != axes[-1]:
        raise ValueError(
            f"serving_mesh: tp_axis {tp_axis!r} must name the last mesh "
            f"axis {axes[-1]!r} for rank-{len(shape)} mesh_shape {shape}")
    return axes


def serving_mesh(shape: Tuple[int, ...], tp_axis: str = "model",
                 device_type: str = "cuda"):
    """The mesh of the sharded serving path (``cfg.mesh_shape``) over the
    ranks of the default process group, one rank per device: axes from
    ``serving_axes``.  Raises with the launcher command that gives the
    ranks it needs when the process group is missing or of another
    size."""
    import torch.distributed as dist
    axes = serving_axes(shape, tp_axis)
    need = 1
    for s in shape:
        need *= int(s)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        where = (f"the process group has {have} ranks" if have
                 else "no process group is initialised")
        raise ValueError(
            f"serving_mesh: mesh_shape {tuple(shape)} needs {need} ranks, "
            f"one per device, but {where}; start {need} processes with "
            f"torchrun --nproc-per-node {need} (or call "
            f"torch.distributed.init_process_group with world_size={need})")
    return make_host_mesh(shape, axes, device_type=device_type)
