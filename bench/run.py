"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up (weights from the seed on the card, the CUDA libraries from the
checkout's ``build/kernels`` cache, the cell's own ramp), measures for
``--seconds``, checks what the timed path produced against the float32
reference, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
untraced, its per-layer ones with ``--trace 1``), ``device`` and, last,
``checks``: each number compared with its limit.  Exits non-zero, with
no result, without a CUDA card, or if JAX or the JAX package got
loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no Flax behind any
    library; the port importable from ``src``."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    # one host thread of CPU math: the serving loop's host work shares
    # the machine's cores with nothing of the harness's own
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench import harness, runner
    cell = harness.resolve(args.workload, ROOT)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {need} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    line = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    if line is None:
        return 1
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
