"""The control of ``correct``: one run of a cell per seed, with the
float32 reference computed in the precision below the configuration's
(float8 e4m3 for bfloat16) put in the program's place: the tokens it
puts first at the positions the program served, or its own three train
steps.  ``--lowp half_batch`` plants a fault of a training cell in the
reference instead.  Each result line holds the control's numbers
against the cell's limits, and its ``correct`` has to come out false;
standard error holds the program's own readings of the same run
(``judged program:``) beside the control's.  The benchmark's own runs
never run it.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 --seconds 10
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lowp", default="fp8",
                    choices=("fp8", "half_batch"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import run as entry
    entry._environment()
    import torch
    from bench import harness, runner
    cell = harness.resolve(args.workload, ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        line = runner.run_cell(cell, seed, args.seconds, False,
                               torch.device("cuda", 0), t, lowp=args.lowp)
        print(json.dumps({"seed": seed, "result": json.loads(line)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
