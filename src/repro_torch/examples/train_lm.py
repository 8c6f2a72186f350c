"""End-to-end LM training example (the minitron-4b smoke config, CPU-
runnable); port of ``examples/train_lm.py``.

Run a few hundred steps with checkpointing; stop it and rerun with
``--resume`` to see the restart from the latest checkpoint:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        [--steps 200] [--resume]

The reference example's arguments, on ``--device`` (``cuda`` unless told
otherwise), with checkpoints under ``--ckpt-dir`` (default: a directory
in the system's temporary directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..launch.train import main as train_main


def train_argv(steps: int, ckpt_dir: str, resume: bool = False):
    """The training CLI's arguments for this example."""
    argv = ["--arch", "minitron-4b", "--smoke", "--steps", str(steps),
            "--batch", "8", "--seq", "64", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "25"]
    return argv + ["--resume"] if resume else argv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and the optimizer")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    args = ap.parse_args(argv)
    return train_main(train_argv(args.steps, args.ckpt_dir, args.resume)
                      + ["--device", args.device])


if __name__ == "__main__":
    main()
