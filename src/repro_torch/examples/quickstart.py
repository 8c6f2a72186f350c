"""Quickstart: the hlslib feature set (F2–F7) in a few lines; port of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

F2's Listing 2 flow and F5's pack run on ``--device`` (``cuda`` unless
told otherwise), F7's tree reduction too; F3/F4's cyclic dataflow and
F6's shift register are host Python.  Each feature prints one line, with
the same values as the JAX example's (F7 to float32 rounding).
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from ..core import (Context, Access, MemoryBank,             # F2
                    DataflowContext, Stream,                 # F3/F4
                    DataPack, pad_to_lanes,                  # F5
                    ShiftReg,                                # F6
                    tree_reduce, Add)                        # F7


def run(device=None) -> List[str]:
    """Run the tour on ``device`` and return its printed lines."""
    lines = []

    # --- F2: the paper's Listing 2, portable host program ---------------
    context = Context(device)                  # sets up the runtime
    program = context.MakeProgram({"Kernel": lambda a, n: a * 2.0})
    input_host = np.full(1024, 5.0, np.float32)
    in_dev = context.MakeBuffer(torch.float32, Access.read,
                                MemoryBank.bank0, input_host)
    kernel = program.MakeKernel("Kernel", in_dev, 1024)
    out = kernel.ExecuteTask()                 # synchronous, like the paper
    lines.append(f"F2 portable host: {out.cpu().numpy()[:3]}")

    # --- F3/F4: cyclic dataflow, hardware-faithful emulation ------------
    mem = list(range(8))
    s0, s1 = Stream(depth=1, name="s0"), Stream(depth=1, name="s1")
    T, N = 3, 8
    with DataflowContext() as df:              # HLSLIB_DATAFLOW_INIT
        df.function(lambda: [s0.Push(mem[i]) for _ in range(T)
                             for i in range(N)])
        df.function(lambda: [s1.Push(s0.Pop() + 1) for _ in range(T * N)])

        def write():
            for _ in range(T):
                for i in range(N):
                    mem[i] = s1.Pop()
        df.function(write)
    lines.append(f"F3 cyclic dataflow (fn^T, hardware semantics): {mem}")

    # --- F5: DataPack ----------------------------------------------------
    x = torch.arange(300.0, device=context.device)
    pack = DataPack.pack(x, width=128)         # lane-aligned wide path
    lines.append(f"F5 datapack: {pack.groups} groups of {pack.width} "
                 f"| padded vocab 50280 -> {pad_to_lanes(50280)}")

    # --- F6: shift register with parallel taps ---------------------------
    reg = ShiftReg(size=8, taps=[0, 3, 7])
    for i in range(10):
        reg.Shift(i)
    lines.append(f"F6 shiftreg taps (0,3,7): {reg[0]} {reg[3]} {reg[7]} "
                 f"| segment buffers: {reg.segment_sizes}")

    # --- F7: guaranteed balanced tree reduction --------------------------
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(1000),
                        dtype=torch.float32, device=context.device)
    lines.append(f"F7 treereduce: {float(tree_reduce(v, Add))} "
                 f"vs torch.sum: {float(torch.sum(v))}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the buffers and tensors")
    args = ap.parse_args(argv)
    for line in run(args.device):
        print(line)


if __name__ == "__main__":
    main()
