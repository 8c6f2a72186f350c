"""Batched serving example: continuous batching over Streams, with the
producer/batcher/consumer trio run as dataflow PEs (paper Listing 4
applied to inference); port of ``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Serves the minitron-4b smoke config with the reference example's
arguments on ``--device`` (``cuda`` unless told otherwise).
"""

from __future__ import annotations

import argparse

from ..launch.serve import main as serve_main

SMOKE_ARGS = ["--arch", "minitron-4b", "--smoke", "--requests", "8",
              "--slots", "4", "--prompt-len", "8", "--max-new", "12",
              "--max-seq", "48"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights, caches and slots")
    args = ap.parse_args(argv)
    serve_main(SMOKE_ARGS + ["--device", args.device])


if __name__ == "__main__":
    main()
