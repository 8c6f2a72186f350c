"""Fault tolerance for training (port of ``train/fault.py``).

* ``Heartbeat``, ``StragglerDetector`` — liveness and slow-step
  detection, from the port's ``core.health``.
* ``elastic_mesh`` — rebuild a smaller (or larger) mesh after failures;
  ``reshard_state`` re-places a checkpointed state onto it (checkpoints
  hold full logical arrays, not raw shards, so any mesh can take them).
* ``TrainSupervisor`` — checkpoint-restart loop: run steps, save every
  N, on a (simulated) failure restore the latest checkpoint and go on;
  the resumed run ends in the uninterrupted run's state bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.health import Heartbeat, StragglerDetector
from ..distributed.sharding import Sharding, place_tree
from ..models.params import tree_map
from . import checkpoint as ckpt

__all__ = ["Heartbeat", "StragglerDetector", "elastic_mesh",
           "reshard_state", "SupervisorReport", "TrainSupervisor"]

# A failure after this many restarts is raised: a fault that recurs on
# every attempt ends the run instead of looping.
MAX_RESTARTS = 10


def elastic_mesh(axis_names: Tuple[str, ...], model_axis: int,
                 ranks: Optional[Sequence[int]] = None, *,
                 device_type: str = "cuda"):
    """Rebuild a mesh after failures: keep the model axis whole (a
    tensor-parallel group must stay complete) and shrink the data axis to
    the ranks that survive — the standard elastic-DP policy.  ``ranks``
    are the surviving ranks of the default process group (default: all
    of them); every rank of the group calls this (building a mesh is
    collective)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    n = (len(ranks) // model_axis) * model_axis
    if n == 0:
        raise RuntimeError("not enough devices for one model-parallel group")
    mesh = torch.tensor(ranks[:n]).reshape(n // model_axis, model_axis)
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(axis_names))


def reshard_state(state, specs, mesh):
    """Re-place a (restored) state tree of nested dicts onto ``mesh``:
    each leaf by its spec in ``specs`` (a tree like ``state``)."""
    return place_tree(state, tree_map(lambda _, s: Sharding(mesh, s),
                                      specs))


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)


class TrainSupervisor:
    """Checkpoint/restart harness around ``step_fn(state, batch) ->
    (state, metrics)``.

    ``fail_at`` injects a simulated failure (``RuntimeError``) before
    the given global steps — the test rig for restart semantics.  A real
    deployment replaces the exception with process death; the restore
    path is the same because saves are atomic.  A failure past
    ``MAX_RESTARTS`` restarts is raised.
    """

    def __init__(self, step_fn: Callable, state: Any, ckpt_dir: str,
                 save_every: int = 10, keep: int = 3):
        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.detector = StragglerDetector()
        self.report = SupervisorReport()

    def run(self, batches: Callable[[int], Any], num_steps: int,
            start_step: int = 0,
            fail_at: Sequence[int] = ()) -> SupervisorReport:
        step = start_step
        fail_at = set(fail_at)
        while step < num_steps:
            try:
                if step in fail_at:
                    fail_at.discard(step)
                    raise RuntimeError(f"simulated node failure @ step {step}")
                t0 = time.monotonic()
                self.state, metrics = self.step_fn(self.state, batches(step))
                dt = time.monotonic() - t0
                if self.detector.observe(dt):
                    self.report.stragglers += 1
                self.report.losses.append(float(metrics["loss"]))
                step += 1
                self.report.steps_run += 1
                if step % self.save_every == 0:
                    ckpt.save(self.ckpt_dir, step, self.state)
                    ckpt.prune(self.ckpt_dir, self.keep)
            except RuntimeError:
                # restart path: restore the latest checkpoint (or go back
                # to the start step with the state as it is).
                if self.report.restarts >= MAX_RESTARTS:
                    raise
                self.report.restarts += 1
                if ckpt.latest_step(self.ckpt_dir) is not None:
                    self.state, step, _ = ckpt.restore(self.ckpt_dir,
                                                       self.state)
                else:
                    step = start_step
        return self.report
