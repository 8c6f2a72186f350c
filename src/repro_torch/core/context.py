"""F2 — portable host runtime (paper §II-B, Listing 2); port of
``core/context.py`` on one device.

The paper: Intel and Xilinx adapted OpenCL to FPGAs differently (one
command queue vs per-kernel queues; extended pointers vs memory flags for
bank placement), so hlslib wraps both behind one API::

    Context -> MakeProgram -> MakeKernel -> ExecuteTask
            -> MakeBuffer(MemoryBank::bank0, ...) -> CopyToHost

PyTorch port: the "vendor" is a torch device — ``cuda`` unless the caller
passes ``device="cpu"`` — or a ``DeviceMesh`` of several.  ``Context``
hides

* the device or the mesh (``MakeBuffer`` places tensors there: with a
  mesh, ``MemoryBank.sharded(*axes)`` makes a DTensor split along those
  mesh axes, a bank of one device a replicated DTensor),
* buffer access modes (a read-only buffer refuses a host rewrite),
* synchronous vs asynchronous execution: ``ExecuteTask`` synchronises the
  device before it returns (the paper's Listing 2 semantics),
  ``ExecuteAsync`` returns as soon as the work is queued.

PyTorch runs eagerly, so ``MakeKernel`` binds a callable to its arguments
and compiles nothing.  The reference's XLA introspection, which serves
its roofline layer, comes from the port's roofline counter
(``roofline/count.py``) run once on fake CPU tensors shaped like the
bound arguments (nothing is computed, nothing written, no kernel
launched): ``cost_analysis()`` gives ``{"flops", "bytes accessed"}``
under the reference's byte model, ``memory_analysis()`` the argument,
output and largest-temporary bytes, and ``hlo_text()`` the aten ops the
callable dispatched (``aten.mm`` for a product) in place of XLA's HLO.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import P, Sharding, is_dtensor


class Access(enum.Enum):
    """Buffer access mode (paper: ``Access::read`` / ``Access::write``)."""
    read = "read"
    write = "write"
    read_write = "read_write"


@dataclasses.dataclass(frozen=True)
class MemoryBank:
    """FPGA DDR banks -> placements.  ``bank0`` and ``bank1`` name the
    paper's two banks for API parity with its Listing 2: replicated
    placements (the whole buffer on the context's device, or on every
    device of its mesh).  ``MemoryBank.sharded(*axes)`` splits a buffer's
    dims along those mesh axes, one entry per dim (``None``: not split);
    on a context of one device it is that device, as a mesh of one device
    would hold it."""
    name: str = "bank0"
    spec: Tuple = ()

    @classmethod
    def sharded(cls, *axes) -> "MemoryBank":
        return cls("sharded", tuple(axes))

    @classmethod
    def replicated(cls) -> "MemoryBank":
        """A replicated placement, as ``bank0`` is."""
        return cls("bank0")


MemoryBank.bank0 = MemoryBank("bank0")  # type: ignore[attr-defined]
MemoryBank.bank1 = MemoryBank("bank1")  # type: ignore[attr-defined]


class Buffer:
    """A tensor on the context's device plus its access mode (≈ cl::Buffer
    + bank)."""

    def __init__(self, ctx: "Context", tensor: torch.Tensor, access: Access,
                 bank: MemoryBank = MemoryBank()):
        self.ctx = ctx
        self.tensor = tensor
        self.access = access
        self.bank = bank

    def CopyToHost(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        t = self.tensor
        host = (t.full_tensor() if is_dtensor(t) else t).cpu().numpy()
        if out is not None:
            np.copyto(out, host)
            return out
        return host

    def CopyFromHost(self, src: np.ndarray) -> "Buffer":
        if self.access == Access.read:
            raise PermissionError("buffer is read-only for the device; "
                                  "host rewrite not allowed")
        # rebind, as the reference's ``device_put`` does: the buffer takes
        # the host data's shape and dtype (no broadcast, no cast) and keeps
        # its placement.  Bound kernels read ``tensor`` at execute time, so
        # they see the new one.
        self.tensor = self.ctx._place(torch.as_tensor(np.asarray(src)),
                                      self.bank)
        return self

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def dtype(self):
        return self.tensor.dtype


def _concrete(args: Tuple[Any, ...]):
    return [a.tensor if isinstance(a, Buffer) else a for a in args]


class Kernel:
    """A callable bound to its arguments (≈ cl::Kernel).  ``ExecuteTask``
    runs it and synchronises the device before returning, matching the
    paper's synchronous semantics; ``ExecuteAsync`` returns the result as
    soon as the work is queued (dispatch-and-continue).  Either takes
    arguments that override the bound ones."""

    def __init__(self, ctx: "Context", fn: Callable, args: Tuple[Any, ...],
                 name: str):
        self.ctx = ctx
        self.fn = fn
        self.name = name
        self.args = args
        self._costs = None

    def ExecuteTask(self, *override_args) -> Any:
        out = self.ExecuteAsync(*override_args)
        self.ctx.synchronize()
        return out

    def ExecuteAsync(self, *override_args) -> Any:
        return self.fn(*_concrete(override_args or self.args))

    def _counted(self):
        """The callable counted once on fake CPU tensors shaped like its
        bound arguments (``roofline.count``)."""
        if self._costs is None:
            from ..roofline import count as C
            fake = C.fake_mode()

            made = {}

            def abstract(a):
                if not isinstance(a, torch.Tensor):
                    return a
                if id(a) not in made:       # one fake per bound tensor
                    with fake:
                        made[id(a)] = torch.empty_strided(
                            a.shape, a.stride(), dtype=a.dtype, device="cpu")
                return made[id(a)]

            args = [abstract(a) for a in _concrete(self.args)]
            with fake:
                _, self._costs = C.count(self.fn, *args)
        return self._costs

    def cost_analysis(self) -> Dict[str, float]:
        c = self._counted()
        return {"flops": c.flops, "bytes accessed": c.bytes}

    def memory_analysis(self) -> Dict[str, int]:
        c = self._counted()
        return {"argument_size_in_bytes": c.argument_bytes,
                "output_size_in_bytes": c.output_bytes,
                "temp_size_in_bytes": c.largest_alloc}

    def hlo_text(self) -> str:
        """The aten ops the callable dispatched, one line each with its
        count, in first-call order."""
        return "\n".join(f"{op}  # {n} call(s)"
                         for op, n in self._counted().ops.items())


class Program:
    """A namespace of kernels (≈ the FPGA binary / .xclbin)."""

    def __init__(self, ctx: "Context", fns: Dict[str, Callable]):
        self.ctx = ctx
        self.fns = dict(fns)

    def MakeKernel(self, name: str, *args, donate: Sequence[int] = ()
                   ) -> Kernel:
        """``donate`` names argument positions whose buffers the caller
        gives up (the reference's XLA donation).  Eager torch has no
        donation: it is accepted and ignored."""
        if name not in self.fns:
            raise KeyError(f"no kernel named {name!r}; have {list(self.fns)}")
        return Kernel(self.ctx, self.fns[name], args, name)


class Context:
    """Sets up the runtime (paper: "Sets up the vendor OpenCL runtime") on
    one torch device, ``cuda`` unless ``device`` says otherwise, or on a
    ``DeviceMesh`` (``mesh``; its device type), whose buffers are
    DTensors."""

    def __init__(self, device=None, mesh=None):
        if mesh is not None:
            device = mesh.device_type
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)

    def _place(self, data: torch.Tensor, bank: MemoryBank) -> torch.Tensor:
        """``data`` (on any device) placed as ``bank`` says."""
        if self.mesh is None:
            return data.to(self.device, copy=True)
        spec = bank.spec + (None,) * (data.dim() - len(bank.spec))
        return Sharding(self.mesh, P(*spec)).place(data)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- paper Listing 2 API -------------------------------------------------------

    def MakeProgram(self, fns: Dict[str, Callable] | Callable) -> Program:
        if callable(fns):
            fns = {getattr(fns, "__name__", "kernel"): fns}
        return Program(self, fns)

    def MakeBuffer(self, dtype: torch.dtype, access: Access, bank: MemoryBank,
                   *shape_or_data) -> Buffer:
        """``MakeBuffer<float, Access::read>(bank, begin, end)`` or
        ``MakeBuffer<float, Access::write>(bank, N[, M, ...])``, placed
        as ``bank`` says."""
        if len(shape_or_data) == 1 and isinstance(shape_or_data[0],
                                                  torch.Tensor):
            data = shape_or_data[0].to(dtype)
        elif len(shape_or_data) == 1 and isinstance(
                shape_or_data[0], (np.ndarray, list)):
            data = torch.as_tensor(np.asarray(shape_or_data[0]), dtype=dtype)
        elif shape_or_data and all(isinstance(s, (int, np.integer))
                                   for s in shape_or_data):
            data = torch.zeros(tuple(int(s) for s in shape_or_data),
                               dtype=dtype)
        else:
            raise TypeError(f"MakeBuffer: pass data or a shape, got "
                            f"{shape_or_data}")
        return Buffer(self, self._place(data, bank), access, bank)
