"""F5 — DataPack: typed wide data paths; port of ``core/datapack.py``.

The paper (§III-B): HLS needs explicitly wide buses to use memory
bandwidth and vectorize compute, but ``ap_uint`` is untyped.
``hlslib::DataPack<T, W>`` is a *typed* W-wide vector with native
indexing, elementwise ops and conversions; one central width constant
resizes every register, bus and buffer of a design.

Here:

* ``LANE`` and the padding helpers (``round_up``, ``pad_to_lanes``,
  ``padded_vocab``, ``padding_waste``, ``assert_lane_aligned``) — the "change
  one typedef" lever every config uses for vocab padding.  The vocab rule
  keeps the reference's value (a multiple of 16 model shards x 128 lanes)
  so both packages declare identical parameter shapes;
* ``DataPack`` — a tensor whose logical last axis is packed into
  (groups, W) with W lane-aligned: typed indexing, ``set``, elementwise
  arithmetic with packs and scalars, conversion to and from flat tensors.

The JAX module's TPU tiling helpers (``sublanes``, ``block_shape_2d``,
``vmem_bytes``, ``fits_vmem``, ``MXU``) size VMEM blocks and are not
carried over; the Hopper counterpart (shared-memory sizing) belongs with
the kernels that need it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

LANE = 128          # the central width (lanes of a TPU vector register)


def round_up(x: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return -(-x // multiple) * multiple


def pad_to_lanes(x: int, lanes: int = LANE) -> int:
    """Pad a logical dimension up to lane alignment."""
    return round_up(x, lanes)


def padded_vocab(vocab: int, model_shards: int = 16, lanes: int = LANE) -> int:
    """Vocab padded to a multiple of ``model_shards * lanes``."""
    return round_up(vocab, model_shards * lanes)


def padding_waste(logical: int, padded: int) -> float:
    """Fraction of FLOPs/bytes spent on padding."""
    return (padded - logical) / padded if padded else 0.0


def assert_lane_aligned(*dims: int, what: str = "dim") -> None:
    """The DataPack bus-width check."""
    for d in dims:
        if d % LANE != 0:
            raise ValueError(
                f"{what}={d} is not lane-aligned (multiple of {LANE}); "
                f"pad with datapack.pad_to_lanes")


@dataclasses.dataclass
class DataPack:
    """A typed W-wide pack over the trailing axis of ``data``.

    ``data`` has shape (..., groups, W) with ``W`` lane-aligned.  Mirrors
    ``hlslib::DataPack``: native indexing (``pack[i]``), elementwise
    arithmetic with packs and scalars, and conversion to/from flat
    tensors.  Packs are values: ``set`` and the operators return new
    packs and leave their operands as they were.
    """

    data: torch.Tensor
    logical: int          # logical (unpadded) trailing size

    @classmethod
    def pack(cls, x: torch.Tensor, width: int = LANE) -> "DataPack":
        if width % LANE != 0:
            raise ValueError(f"DataPack width {width} must be a multiple of "
                             f"LANE={LANE}")
        logical = x.shape[-1]
        padded = round_up(logical, width)
        if padded != logical:
            x = F.pad(x, (0, padded - logical))
        return cls(data=x.reshape(x.shape[:-1] + (padded // width, width)),
                   logical=logical)

    def unpack(self) -> torch.Tensor:
        flat = self.data.reshape(self.data.shape[:-2] + (-1,))
        return flat[..., : self.logical]

    @property
    def width(self) -> int:
        return self.data.shape[-1]

    @property
    def groups(self) -> int:
        return self.data.shape[-2]

    def __getitem__(self, i) -> torch.Tensor:
        return self.data[..., i, :]

    def set(self, i, value) -> "DataPack":
        data = self.data.clone()
        data[..., i, :] = value
        return DataPack(data, self.logical)

    def _binop(self, other, op) -> "DataPack":
        if isinstance(other, DataPack):
            if other.width != self.width:
                raise ValueError("DataPack width mismatch: "
                                 f"{self.width} vs {other.width}")
            other = other.data
        return DataPack(op(self.data, other), self.logical)

    def __add__(self, o): return self._binop(o, torch.add)
    def __radd__(self, o): return self._binop(o, torch.add)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __rmul__(self, o): return self._binop(o, torch.mul)
    def __truediv__(self, o): return self._binop(o, torch.div)
