"""Roofline terms of a counted step (port of ``roofline/analysis.py``)
for one H100.

    compute    = FLOPs (per device) / PEAK_BF16_FLOPS
    memory     = bytes (per device) / HBM_BW
    collective = collective bytes (per device) / NVLINK_BW

FLOPs and bytes come from ``count.Counter`` (the port's counterpart of
the reference's HLO walker), which sees one device's work, so no
division by chips.  The reference's ``collective_bytes`` parses XLA's
HLO text for collectives; eager PyTorch has no such text, and one card
runs no collective, so it has no counterpart here and the collective
term is 0.  MODEL_FLOPS uses 6·N·D (train) or 2·N·D (inference), N =
active parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import hw

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    model_flops_global: float
    n_active_params: int
    peak_memory_per_device: Optional[float] = None
    scopes_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    scopes_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    scopes_coll: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / hw.PEAK_BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def useful_flops_ratio(self, n_chips: int) -> float:
        counted = self.flops_per_device * n_chips
        return self.model_flops_global / counted if counted else 0.0

    def mfu_bound(self, n_chips: int) -> float:
        """Model-FLOPs utilization if the dominant term were the wall
        clock: MODEL_FLOPS / (t_bound · chips · peak)."""
        denom = self.t_bound * n_chips * hw.PEAK_BF16_FLOPS
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self, n_chips: int) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_bound_s": self.t_bound,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio(n_chips),
            "mfu_bound": self.mfu_bound(n_chips),
            "peak_memory_per_device": self.peak_memory_per_device,
            "n_chips": n_chips,
            "scopes_flops": self.scopes_flops,
            "scopes_bytes": self.scopes_bytes,
            "scopes_coll": self.scopes_coll,
        }


def model_flops(cfg, shape, n_active: int) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def analyze(counts, cfg, shape, mesh_name: str, n_chips: int,
            n_active: int) -> Roofline:
    """Roofline terms from a counted step (``count.Costs``): the
    reference's ``analyze`` with the counter in place of the compiled
    HLO.  ``peak_memory_per_device``: arguments + outputs + the largest
    single temporary (the counter has no liveness analysis, so this is
    a floor of the peak, not XLA's buffer assignment)."""
    from . import count
    coll = {k: 0 for k in _COLLECTIVES}
    coll["total"] = int(counts.coll.get("total", 0))
    roof = Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name,
        flops_per_device=float(counts.flops),
        bytes_per_device=float(counts.bytes),
        collective_bytes_per_device=float(coll["total"]),
        collectives=coll,
        model_flops_global=model_flops(cfg, shape, n_active),
        n_active_params=n_active,
        peak_memory_per_device=float(counts.argument_bytes
                                     + counts.output_bytes
                                     + counts.largest_alloc))
    roof.scopes_flops = dict(count.top_scopes(counts.by_scope_flops))
    roof.scopes_bytes = dict(count.top_scopes(counts.by_scope_bytes))
    return roof
