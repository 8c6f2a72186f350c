"""F3 compiled mode — the dataflow graph lowered to a pipeline (port of
``core/pipeline.py``).

The software emulator (``core.dataflow``) runs PEs as threads.  On
hardware, hlslib's DATAFLOW region is inlined and the PEs overlap.  The
distributed analogue of that inlining is a **pipeline-parallel
schedule**: each PE becomes a stage owned by one rank, stream edges
become ``ppermute`` hops, and stream *depth* becomes the number of
microbatches in flight.

* ``fused_pipeline`` — every stage composed over each microbatch in
  order on one device; the semantic reference.
* ``gpipe_pipeline`` — the GPipe schedule over the ranks of a process
  group, one rank per stage: ``num_micro + num_stages - 1`` ticks, each
  computing every stage on its in-flight microbatch and hopping the
  activations to the next stage.  Bubble fraction = (S-1)/(M+S-1),
  reported by ``pipeline_efficiency`` so perf work can size microbatch
  counts.
* ``gpipe_train_step`` — autograd through that schedule: every hop's
  gradient takes the reverse hop, so the backward is the mirrored
  pipeline.

All consume the same per-stage functions, so tests can assert the
pipeline computes exactly what sequential composition computes — the
compiled-world version of the paper's "software must match hardware".
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .collectives import axis_index, axis_size, ppermute


def fused_pipeline(stage_fns: Sequence[Callable], xs: torch.Tensor
                   ) -> torch.Tensor:
    """Run every microbatch ``xs[m]`` through all stages in order and
    stack the results (the reference's ``lax.scan`` over microbatches)."""
    ys = []
    for x in xs:
        for f in stage_fns:
            x = f(x)
        ys.append(x)
    return torch.stack(ys)


def pipeline_efficiency(num_micro: int, num_stages: int) -> float:
    """GPipe utilization = M / (M + S - 1)."""
    return num_micro / (num_micro + num_stages - 1)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the group's ranks of ``x``, a value each rank then uses
    as the same replicated value: the gradient every rank holds is the
    replicated value's, so it passes through unchanged.  ``tail`` (the
    rank's last activation) takes a zero gradient: it ties every rank's
    schedule to the result, so each rank runs every hop's backward."""

    @staticmethod
    def forward(ctx, x, tail, group):
        ctx.tail = (tail.shape, tail.dtype, tail.device)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return g, torch.zeros(shape, dtype=dtype, device=device), None


def gpipe_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, xs: torch.Tensor, group=None
                   ) -> torch.Tensor:
    """GPipe schedule over the ranks of ``group`` (rank s = stage s).

    ``stage_fn(params_slice, x) -> x`` is one PE; ``stage_params`` (a
    tensor or a dict of them) has a leading stage axis, of which rank s
    uses slice s; ``xs`` is (num_micro, micro_batch, ...), the same on
    every rank, and so is the result.

    Each rank runs ``num_micro + S - 1`` ticks: on tick ``t`` stage
    ``s`` processes microbatch ``t - s`` (when in range), then the
    activations hop ``s -> s+1`` (a depth-1 FIFO edge, the bounded-FIFO
    semantics of the emulator).  The last stage commits the finished
    microbatches, and they are broadcast back by mask-and-sum (a hop
    cannot fan one source out to all), as the reference does."""
    S, s = axis_size(group), axis_index(group)
    M = xs.shape[0]
    params = _index(stage_params, s)
    fwd = [(i, i + 1) for i in range(S - 1)]
    inflight = torch.zeros_like(xs[0])
    outputs = [torch.zeros_like(xs[0]) for _ in range(M)]
    for t in range(M + S - 1):
        # stage 0 injects microbatch t; the others take the activation
        # that arrived over the edge.  Every tick computes the stage and
        # keeps its output only while microbatch t - s is in range, as
        # the reference does: each hop then depends on the parameters on
        # every rank, so every rank runs every hop's backward, in the
        # same order.
        x_in = torch.where(torch.tensor(s == 0), xs[min(t, M - 1)],
                           inflight)
        active = 0 <= t - s < M
        y = torch.where(torch.tensor(active), stage_fn(params, x_in),
                        inflight)
        if s == S - 1 and active:
            outputs[t - (S - 1)] = y
        inflight = ppermute(y, group, fwd)
    out = torch.stack(outputs)
    return _ReplicatedSum.apply(out if s == S - 1 else torch.zeros_like(out),
                                inflight, group)


def gpipe_train_step(stage_fn: Callable, loss_fn: Callable,
                     stage_params: Any, xs: torch.Tensor,
                     targets: torch.Tensor, group=None):
    """Pipeline-parallel training by autograd THROUGH the GPipe schedule:
    every ``ppermute`` edge's gradient takes the reverse hop, so the
    backward is the mirrored pipeline.  Memory is O(num_micro) stashed
    activations per stage (classic GPipe).

    Returns (loss, grads): ``grads`` like ``stage_params``, each rank's
    stage slice summed over the group, so every rank holds all of them."""
    leaves = ([stage_params] if isinstance(stage_params, torch.Tensor)
              else [stage_params[k] for k in sorted(stage_params)])
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        tree = (live[0] if isinstance(stage_params, torch.Tensor)
                else dict(zip(sorted(stage_params), live)))
        ys = gpipe_pipeline(stage_fn, tree, xs, group)
        loss = loss_fn(ys, targets)
        grads = torch.autograd.grad(loss, live)
    grads = [g.contiguous() for g in grads]
    for g in grads:
        dist.all_reduce(g, group=group)
    if isinstance(stage_params, torch.Tensor):
        return loss.detach(), grads[0]
    return loss.detach(), dict(zip(sorted(stage_params), grads))
