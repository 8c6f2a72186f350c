"""Mesh factories (port of ``launch/mesh.py``): ``DeviceMesh`` builders.

Functions, not module-level constants: importing this module touches no
device and starts no process group.  Each builder expects the process
group to be up (``torch.distributed.init_process_group``) with as many
ranks as the mesh has devices; ``device_type`` is ``"cuda"`` (NCCL) by
default, ``"cpu"`` (gloo) when the caller asks, as the tests do.
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
