"""Run a function on N gloo ranks of the CPU, each its own process.

``run_ranks(world, "module:function", tmp_path, *args)`` starts ``world``
Python processes.  Each one joins a gloo process group through a
``FileStore`` under ``tmp_path`` (no TCP port, so parallel test workers
cannot collide), takes one thread, imports ``module`` from this
directory or ``src/``, calls ``function(rank, world, *args)`` and
pickles its return value.  The parent waits for all of them up to a
deadline; on a timeout or a non-zero exit it kills the group and fails
with every rank's stderr.  Nothing is retried.

The rank functions live in modules that import torch and the port only
(``_torch_rank_fns.py``): a rank never imports JAX.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
PG_TIMEOUT = timedelta(seconds=60)


def run_ranks(world: int, target: str, tmp_path, *args,
              deadline: float = 90.0):
    """[function's return value on rank r for r in range(world)]."""
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=str(tmp_path))
    with open(os.path.join(tmp, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    procs, errs = [], []
    for r in range(world):
        env = dict(os.environ, RANKS_RANK=str(r), RANKS_WORLD=str(world),
                   RANKS_DIR=tmp, RANKS_TARGET=target,
                   PYTHONPATH=os.pathsep.join(
                       [HERE, SRC, os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
        errs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import _torch_ranks; _torch_ranks._child()"],
            env=env, stdout=subprocess.DEVNULL, stderr=err))
    end = time.monotonic() + deadline
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out or any(p.returncode for p in procs):
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        report = []
        for r, err in enumerate(errs):
            err.seek(0)
            report.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                          + err.read()[-4000:])
        for err in errs:
            err.close()
        why = (f"timed out after {deadline:.0f} s" if timed_out
               else "a rank failed")
        pytest.fail(f"{target} on {world} ranks: {why}\n" + "\n".join(report),
                    pytrace=False)
    for err in errs:
        err.close()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child():
    import importlib

    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANKS_RANK"])
    world = int(os.environ["RANKS_WORLD"])
    tmp = os.environ["RANKS_DIR"]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        mod, fn = os.environ["RANKS_TARGET"].split(":")
        result = getattr(importlib.import_module(mod), fn)(rank, world,
                                                           *args)
        with open(os.path.join(tmp, f"rank{rank}.out"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
