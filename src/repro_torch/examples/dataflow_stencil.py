"""The paper's stencil example (Listing 6) end to end; port of
``examples/dataflow_stencil.py``.

    PYTHONPATH=src python -m repro_torch.examples.dataflow_stencil --device cpu

1. the eager ``ShiftReg`` stencil (software emulation, hlslib-faithful),
   on the host, with the paper's tap layout;
2. one kernel sweep, ``ops.stencil(use_pallas=True)``: kernel B8 on the
   card, its plain twin on the CPU;
3. iterated sweeps, ``stencil2d_iterated`` — the cyclic-dataflow
   workload of paper §II-C.

Each stage prints its max abs error against ``ref.stencil2d_ref``.  The
grid is drawn from ``--seed`` with numpy (standard normal, float32), as
in the JAX example.  Stages 2 and 3 run on ``--device`` (``cuda`` unless
told otherwise) at ``--height`` x ``--width``; the eager stage is a
per-element Python loop, so it runs on the grid's top-left corner of at
most ``EAGER_SHAPE``, taken as a grid of its own.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.shiftreg import ShiftReg
from ..kernels import ops, ref
from ..kernels.stencil import stencil2d_iterated

EAGER_SHAPE = (64, 128)


def make_grid(height: int, width: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (height, width)).astype(np.float32)


def eager_stencil(x: np.ndarray) -> np.ndarray:
    """Stream the zero-padded grid row-major through a register spanning
    two padded rows (size 2*Wp+1, Wp = W+2) with taps south/east/west/
    north at 0, Wp-1, Wp+1, 2*Wp — the paper's Listing 6 register layout."""
    H, W = x.shape
    padded = np.pad(x, 1)
    Wp = W + 2
    reg = ShiftReg(2 * Wp + 1, taps=[0, Wp - 1, Wp + 1, 2 * Wp], fill=0.0)
    out = np.zeros_like(x)
    for idx, v in enumerate(padded.flatten()):
        reg.Shift(v)
        # the window centre is one padded row behind the stream head
        pi, pj = divmod(idx - Wp, Wp)
        if 1 <= pi <= H and 1 <= pj <= W:
            north, west, east, south = reg[2 * Wp], reg[Wp + 1], \
                reg[Wp - 1], reg[0]
            out[pi - 1, pj - 1] = 0.25 * (north + west + east + south)
    return out


def kernel_stages(x: torch.Tensor, iters: int):
    """Stages 2 and 3 on x's device: (one sweep, ``iters`` sweeps)."""
    return ops.stencil(x, use_pallas=True), stencil2d_iterated(x, iters)


def run(height: int = 64, width: int = 128, iters: int = 4,
        device: str = "cuda", seed: int = 0):
    """All three stages; returns their max abs errors against the oracle
    as (eager, kernel, iterated)."""
    x = make_grid(height, width, seed)
    xe = np.ascontiguousarray(x[:EAGER_SHAPE[0], :EAGER_SHAPE[1]])
    want_e = ref.stencil2d_ref(torch.from_numpy(xe)).numpy()
    err_eager = np.abs(eager_stencil(xe) - want_e).max()
    xt = torch.from_numpy(x).to(device)
    got, it = kernel_stages(xt, iters)
    err_kernel = (got - ref.stencil2d_ref(xt)).abs().max().item()
    err_it = (it - ref.stencil2d_ref(xt, iters)).abs().max().item()
    return err_eager, err_kernel, err_it


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--iters", type=int, default=4,
                    help="sweeps of the iterated (cyclic) stage")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the kernel stages")
    args = ap.parse_args(argv)
    e, k, it = run(args.height, args.width, args.iters, args.device,
                   args.seed)
    print("eager ShiftReg max err:", e)
    print("kernel max err:", k)
    print("iterated (cyclic) max err:", it)


if __name__ == "__main__":
    main()
