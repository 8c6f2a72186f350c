"""Fault tolerance for training (port of ``train/fault.py``).

* ``Heartbeat``, ``StragglerDetector`` — liveness and slow-step
  detection, from the port's ``core.health``.
* ``TrainSupervisor`` — checkpoint-restart loop: run steps, save every
  N, on a (simulated) failure restore the latest checkpoint and go on;
  the resumed run ends in the uninterrupted run's state bit for bit.

``elastic_mesh`` and ``reshard_state`` (re-meshing after a lost device)
wait for the tensor-parallel port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Sequence

from ..core.health import Heartbeat, StragglerDetector
from . import checkpoint as ckpt

__all__ = ["Heartbeat", "StragglerDetector", "SupervisorReport",
           "TrainSupervisor"]

# A failure after this many restarts is raised: a fault that recurs on
# every attempt ends the run instead of looping.
MAX_RESTARTS = 10


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
