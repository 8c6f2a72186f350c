"""F6 — shift registers with parallel access (paper §III-C); port of
``core/shiftreg.py``.

The paper: FPGA codes buffer streamed elements for a *constant* number
of cycles (sliding windows for stencils), so hlslib provides an explicit
shift register whose taps are compile-time constants, checked ascending,
with the buffers between taps sized from consecutive-tap distances.

The pattern — "an element pushed now is consumed again at fixed future
offsets" — is the rolling KV buffer of sliding-window attention, the
depthwise causal conv of Mamba2 (a K-tap register over time) and the
halo of a stencil.  This module gives:

* ``ShiftReg`` — an eager, stateful shift register for the dataflow
  software-emulation world (single input, parallel static taps,
  ascending-offset check at construction);
* ``shift_window`` / ``causal_conv_shiftreg`` — tensor formulations: a
  loop whose carried state is the register contents, i.e. the hardware
  register made explicit (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch


class ShiftReg:
    """Explicit shift register with parallel taps (software emulation).

    ``taps`` are constant offsets (0 = most recently pushed), strictly
    ascending — hlslib's constraint that the buffers between consecutive
    taps be well defined.  ``size`` is the total delay (the largest
    reachable offset + 1).
    """

    def __init__(self, size: int, taps: Sequence[int], fill=0):
        taps = list(taps)
        if any(t < 0 or t >= size for t in taps):
            raise ValueError(f"taps {taps} out of range for size {size}")
        if taps != sorted(set(taps)):
            raise ValueError(
                f"taps must be strictly ascending (got {taps}) — "
                "consecutive-tap distances define the internal buffers")
        self.size = size
        self.taps = taps
        # distances between consecutive taps: the per-segment buffer sizes
        # a hardware implementation would instantiate (paper §III-C).
        bounds = taps + [size]
        self.segment_sizes = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
        self._buf: List[Any] = [fill] * size

    def Shift(self, value) -> None:
        """Push one element; the oldest falls off the end."""
        self._buf.insert(0, value)
        self._buf.pop()

    def Get(self, tap: int):
        """Read a tap — only *declared* taps are readable."""
        if tap not in self.taps:
            raise KeyError(f"tap {tap} was not declared (taps={self.taps})")
        return self._buf[tap]

    def __getitem__(self, tap: int):
        return self.Get(tap)


# --- tensor formulations ----------------------------------------------------------


def shift_window(x: torch.Tensor, window: int, fill=0.0) -> torch.Tensor:
    """All ``window`` taps of a shift register over axis 0.

    Returns ``y[t, k] = x[t - k]`` (``fill`` before the start), shape
    ``(T, window) + x.shape[1:]``: the dense unrolling of the register.
    """
    T = x.shape[0]
    pad = torch.full((window - 1,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=0)
    idx = (torch.arange(T, device=x.device)[:, None]
           + (window - 1 - torch.arange(window, device=x.device))[None, :])
    return xp[idx]


def causal_conv_shiftreg(x: torch.Tensor, kernel: torch.Tensor,
                         state: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time as an explicit shift register.

    ``x``: (T, C), ``kernel``: (K, C).  The loop's carried state *is* the
    register contents (K-1, C).  Returns (y (T, C), final state (K-1, C));
    ``state`` seeds the register (decode: one step at a time), so a
    stream split in two with the state carried across equals one pass.
    """
    K, C = kernel.shape
    reg = (torch.zeros((K - 1, C), dtype=x.dtype, device=x.device)
           if state is None else state)
    ys = []
    for xt in x:
        window = torch.cat([reg, xt[None]], dim=0)        # (K, C)
        ys.append(torch.sum(window * kernel, dim=0))      # all taps
        reg = window[1:]
    y = torch.stack(ys) if ys else x.new_zeros((0, C))
    return y, reg


def causal_conv_ref(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Oracle: the same depthwise causal conv by padding + windowing."""
    K, _ = kernel.shape
    taps = shift_window(x, K)              # (T, K, C), taps[t, k] = x[t-k]
    # kernel[k] multiplies x[t - (K-1-k)] in the register formulation.
    return torch.einsum("tkc,kc->tc", taps.flip(1), kernel)


def sliding_window_indices(t: int, window: int) -> np.ndarray:
    """Static tap index set for a sliding attention window ending at ``t``."""
    return np.arange(max(0, t - window + 1), t + 1)

