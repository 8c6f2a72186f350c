"""F3 compiled mode on one device (port of ``core/pipeline.py``'s
single-device half).

The software emulator (``core.dataflow``) runs PEs as threads.  On
hardware, hlslib's DATAFLOW region is inlined and the PEs overlap.
``fused_pipeline`` is the semantic reference of that lowering: every
stage composed over each microbatch in order.  ``pipeline_efficiency``
is the GPipe utilisation M / (M + S - 1) that sizes microbatch counts.
The GPipe schedule over a mesh axis (``gpipe_pipeline``,
``gpipe_train_step``) comes with tensor-parallel serving.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def fused_pipeline(stage_fns: Sequence[Callable], xs: torch.Tensor
                   ) -> torch.Tensor:
    """Run every microbatch ``xs[m]`` through all stages in order and
    stack the results (the reference's ``lax.scan`` over microbatches)."""
    ys = []
    for x in xs:
        for f in stage_fns:
            x = f(x)
        ys.append(x)
    return torch.stack(ys)


def pipeline_efficiency(num_micro: int, num_stages: int) -> float:
    """GPipe utilization = M / (M + S - 1)."""
    return num_micro / (num_micro + num_stages - 1)
