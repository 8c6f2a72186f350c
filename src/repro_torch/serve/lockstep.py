"""Host decisions of a sharded serve, made once and followed by every rank.

Sharded serving is SPMD: each rank is a process with its own
``ContinuousBatcher``, its own request stream (fed the same requests in
the same order by its own producer) and its own clock.  The steps are
collectives, so every rank must take the same request at the same
point, expire the same deadline at the same step and order the same SLA
queue, or the ranks' block tables drift apart and the group hangs.  The
batcher reads three inputs that differ from rank to rank: its request
stream (what a non-blocking pop finds there depends on when the
producer ran), its clock, and the wall time of its steps (the SLA
shedding estimate), plus the supervisor's watchdog flag.

``Lockstep`` makes rank 0 decide each of them and broadcasts the
decision: a non-blocking pop becomes rank 0's pop
followed by a blocking pop of the same request (checked by its ``rid``)
everywhere else, taking its ``submitted_at`` from rank 0, and the
clock reading, the smoothed step time and the stall flag come from rank
0 once per iteration of the batcher's loop (``tick``).  Everything else
the batcher decides (admission, page allocation, preemption, drafts,
tier policy, the fault plan's ordinals) is a function of those inputs
and of the tokens, which the replicated step outputs make equal.

With ``overload="reject"`` the shed at a full queue is one more such
decision (``try_push``): rank 0 tries its own queue and every rank's
producer follows its outcome, pushing the request or failing it with
the same ``queue_full`` rejection.  Producers run in threads of their
own, beside the serving loop, so these decisions go over a process
group of their own: the two threads' collectives never interleave on
one group in different orders on different ranks.  That group is gloo
over CPU tensors whatever the default backend is: a shed decision is
host data, and two NCCL communicators driven from two threads in an
order that may differ by rank can deadlock, so NCCL stays out of the
producers' threads.  It is made only for ``overload="reject"``.

Each decision of the loop is one broadcast of a few float64 values over
the default group's backend: CPU tensors on gloo, CUDA tensors on
NCCL.

A rank that cannot follow (its producer is late past
``FOLLOW_TIMEOUT_S``, fed it another request, or closed its stream)
raises ``LockstepError``: the serve is broken, and the batcher's loop
lets it through instead of waiting on.  Its peers, blocked in their next
decision, end when the failed rank's process leaves the group (the
transport reports the lost peer) or at the group's timeout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# how long a rank waits on its own stream for a request rank 0 already
# took before it calls the serve broken (its producer is late or fed it
# other requests).
FOLLOW_TIMEOUT_S = 300.0

_NONE, _GOT, _CLOSED = 0.0, 1.0, 2.0


class LockstepError(RuntimeError):
    """This rank cannot take the request rank 0 took: the ranks' states
    would drift apart, so the sharded serve cannot go on.  ``request``
    is the other request this rank popped instead, if any: it is still
    owed an outcome."""

    def __init__(self, msg: str, request=None):
        super().__init__(msg)
        self.request = request


class Lockstep:
    """Rank 0 of the default process group decides, every rank
    follows.  ``shed``: the batcher sheds at a full queue
    (``overload="reject"``), so ``try_push`` gets its gloo group."""

    def __init__(self, shed: bool = False):
        import torch.distributed as dist
        self.rank = dist.get_rank()
        self.leader = self.rank == 0
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if dist.get_backend() == "nccl"
                        else torch.device("cpu"))
        # the producers' group (every rank makes it here, in the same
        # order, as ``new_group`` requires).
        self._push_group = dist.new_group(backend="gloo") if shed else None
        self.now: Optional[float] = None

    def _bcast(self, values: List[float], group=None,
               device=None) -> List[float]:
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.float64,
                         device=device or self._device)
        dist.broadcast(t, src=0, group=group)
        return t.tolist()

    def tick(self, now: float, step_s: float, stalled: bool
             ) -> Tuple[float, float, bool]:
        """Rank 0's clock reading, smoothed step seconds and stall flag,
        on every rank; the clock reading is kept as ``now``."""
        now, step_s, stalled = self._bcast([now, step_s, float(stalled)])
        self.now = now
        return now, step_s, bool(stalled)

    def _decide(self, r, kind: float) -> List[float]:
        """Broadcast rank 0's pop (``r`` on rank 0, None elsewhere): [kind,
        rid, submitted_at] on every rank.  If the broadcast fails, the
        request rank 0 popped goes with the ``LockstepError``."""
        _check_rid(r)
        try:
            return self._bcast([kind, r.rid, r.submitted_at] if r is not None
                               else [kind, 0.0, 0.0])
        except Exception as e:
            if r is None:
                raise
            raise LockstepError(f"lockstep: rank 0's pop of request {r.rid} "
                                f"reached no peer: {e}", request=r) from e

    def _follow(self, stream, rid: float, submitted_at: float):
        from ..core.stream import StreamClosed
        try:
            r = stream.Pop(timeout=FOLLOW_TIMEOUT_S)
        except TimeoutError:
            raise LockstepError(
                f"lockstep: rank {self.rank} waited {FOLLOW_TIMEOUT_S:g} s "
                f"for request {int(rid)}, which rank 0 took; its producer "
                "is late or fed it other requests") from None
        except StreamClosed:
            raise LockstepError(
                f"lockstep: rank {self.rank}'s request stream closed before "
                f"request {int(rid)}, which rank 0 took") from None
        if r.rid != rid:
            raise LockstepError(
                f"lockstep: rank {self.rank} popped request {r.rid} where "
                f"rank 0 took {int(rid)}; every rank's producer must submit "
                "the same requests in the same order", request=r)
        r.submitted_at = submitted_at
        return r

    def try_pop(self, stream):
        """Rank 0's ``stream.TryPop()``, taken from every rank's own
        stream (blocking there until it arrives)."""
        r = stream.TryPop() if self.leader else None
        got, rid, at = self._decide(r, _GOT if r is not None else _NONE)
        if got == _NONE:
            return None
        return r if self.leader else self._follow(stream, rid, at)

    def try_push(self, stream, r) -> bool:
        """Rank 0's ``stream.TryPush(r)``, from a producer's thread:
        whether the request entered the queue, on every rank.  A rank
        other than 0 then pushes it too (blocking: its loop takes the
        same requests as rank 0's, so its queue is never the fuller)
        or, like rank 0, sheds it.  A rank whose producer submits
        another request than rank 0's at this point raises
        ``LockstepError``."""
        _check_rid(r)
        if self._push_group is None:
            raise RuntimeError("lockstep: try_push needs Lockstep(shed=True)")
        ok = stream.TryPush(r) if self.leader else False
        got, rid = self._bcast([float(ok), float(r.rid)], self._push_group,
                               torch.device("cpu"))
        if rid != r.rid:
            raise LockstepError(
                f"lockstep: rank {self.rank} submitted request {r.rid} where "
                f"rank 0 submitted {int(rid)}; every rank's producer must "
                "submit the same requests in the same order", request=r)
        if got and not self.leader:
            stream.Push(r)
        return bool(got)

    def pop(self, stream, timeout: float):
        """Rank 0's ``stream.Pop(timeout)``: the request, None on a
        timeout, or ``StreamClosed`` raised on every rank."""
        from ..core.stream import StreamClosed
        r, kind = None, _NONE
        if self.leader:
            try:
                r, kind = stream.Pop(timeout=timeout), _GOT
            except TimeoutError:
                pass
            except StreamClosed:
                kind = _CLOSED
        kind, rid, at = self._decide(r, kind)
        if kind == _CLOSED:
            raise StreamClosed("rank 0's request stream closed")
        if kind == _NONE:
            return None
        return r if self.leader else self._follow(stream, rid, at)


def _check_rid(r) -> None:
    if r is not None and not -2 ** 53 <= r.rid <= 2 ** 53:
        raise ValueError(f"lockstep: request id {r.rid} does not fit a "
                         "float64 exactly")
