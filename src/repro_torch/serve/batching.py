"""Continuous batching over dense slots or paged KV (port of
``serve/batching.py``).

Requests arrive on a bounded ``Stream``; the batcher packs them into
fixed slots, decodes all active slots together with one batched step,
and retires finished sequences into per-request output streams,
immediately reusing the slot.  The per-slot decode state (last token,
position, remaining budget, active mask) lives in device tensors; the
only per-step device-to-host transfer is the (2, n_slots) int32 array of
next tokens and finished flags (a verify step's (k + 3, n_slots) block).

Dense-slot mode (``kv_page_size == 0``, the CLI's default, or a family
with no pageable layout, as the recurrent ssm/hybrid families): every
slot owns a full ``max_seq`` row of the dense cache (or its recurrent
state).  Admission pads each prompt to a power-of-two bucket (at least
``_MIN_BUCKET``; recurrent families: the exact length) and prefills at
``n_slots`` rows per bucket, the placed rows scattered into their slots;
the decode step runs every slot at its own position in one batched
forward.

Paged mode: every attention layer owns a shared device page pool
(the flat ``CacheLayout``), a host ``PageAllocator`` hands pages to
requests, and a per-slot block table maps logical page j to a physical
page.  Prompts are admitted in chunks (chunked prefill), interleaved
with decode steps (``prefill_interleave`` decodes between chunks).
Admission reserves only the prompt's pages; decode grows a slot's table
on demand, and when the pool runs dry the lowest-priority slot (ties:
the most recently admitted) is preempted: its pages are spilled to the
host, freed, and restored bit-identically — possibly into another slot
— once pages free up.  ``reserve_decode`` (or ``cfg.kv_reserve_decode``)
reserves the worst case (prompt + ``max_new``) at admission instead, so
decode never grows a table or preempts; at equal pool size it admits
fewer slots at once.  A request whose prompt cannot get pages waits at
the head of the FIFO; one that could not fit even an empty pool is
rejected.

Refcounted prefix cache (paged, ``prefix_cache``): retiring requests
hand their prompt's full pages to a radix-tree ``PrefixIndex`` instead
of freeing them; a later request whose prompt shares the prefix attaches
those pages (incref) and starts its chunked prefill at the chunk-grid
point at or below the divergence, its writes below the matched offset
suppressed (``cache_offset``).  The first write past a shared page — the
catch-up prefill crossing a mid-page divergence, or decode growing past
a fully matched prompt — copies the page first (copy-on-write), so
shared pages stay bit-stable for every sequence aliasing them.  Cached
prefixes linger until pool pressure LRU-evicts them, always before any
live slot is preempted; a preempted slot spills only its private pages
and keeps its references on the shared ones.  ``prefill_exact``
recomputes the whole remaining prompt span in the final (pow2-bucketed)
chunk, so the installed cache is bit-identical however the prompt was
chunked.

Speculative decode (paged, ``cfg.speculate_k``): a self-speculative
n-gram drafter proposes up to ``speculate_k`` tokens per slot from the
slot's own history, and ONE batched verify call (span ``speculate_k +
1``) scores them; the longest prefix of drafts agreeing with greedy
argmax commits (at least one token per slot).  The span writes into
freshly allocated scratch pages, swapped into a copy of the block table
inside the call: a rejected tail rolls back by freeing its scratch, a
commit scatters it into the slot's table, and the token stream equals
plain greedy decode's.  A per-slot acceptance EWMA self-disables
drafting on text that does not repeat, with re-probes on a backed-off
step grid.

Tiered KV memory (paged, prefix cache, ``host_tier_bytes``): a bounded
host-RAM tier (``serve.kv_tiers``) sits behind the page pool.  Prefix
eviction demotes the evicted node's pages to the host store through the
batcher's one ``StagedTransferEngine`` (which also carries every
preemption spill and restore); a later prompt that misses the device
index but hits the host store promotes the block chain back (pages
allocated, payloads scattered in one staged transfer, blocks re-inserted
into the index) and then admits as an ordinary shared-page hit, catch-up
chunk only, bit-identical to the cold run.  ``tier_snapshot`` persists the
host store across batcher restarts (T2).  ``tier_restore_min`` is the
recompute-vs-restore policy: shorter spans recompute from tokens (short
rehits prefill; short preempted sequences park as recompute records that
re-admit and replay their emitted tokens with output pushes suppressed).

Resilience (``serve.resilience``): every request ends in exactly one
terminal outcome, retired or a typed ``TerminalEvent`` pushed into its
stream before the close, which ``drain`` re-raises as the matching
``RequestFailed`` subclass.  ``Request.klass`` maps onto preemption rank
and, with ``schedule="sla"``, admission order; ``deadline_ms`` expires
queued work and cancels in-flight work, its pages freed at once.
``overload="reject"`` sheds at a full queue.  A seeded ``FaultPlan``
fires at the sites ``step``, ``chunk``, ``verify``, ``alloc``, ``t1_d2h``,
``t1_h2d``, ``snapshot_corrupt`` and ``snapshot_truncate``.  Transfer
faults take the degradation ladder (retry with capped backoff, then
recompute, then tier-off after ``tier_fault_limit`` failures); a step,
verify or stall fault is fatal (``BatcherFault``), and under a
``ServeSupervisor`` the batcher journals its in-flight requests, rebuilds
its pools (``recover``) and replays them bit-identically.

Telemetry (``serve.telemetry``, ``telemetry=``): a ``ServeTelemetry``
takes lifecycle events (submit, admit with its prefix-hit and
copy-on-write detail, prefill chunks, first token, tokens, speculation
counts, preempt / spill / restore / resume, retire or the typed
terminal, the recover journal) and the latency histograms, at the
reference's sites behind one ``if`` each.  Its tracer also takes the
loop's host spans: ``serve.iteration`` (one loop iteration, after the
heartbeat) holding ``serve.admit``, ``serve.prefill_chunk`` and
``serve.decode_step`` (the whole ``step()`` call, ``n_live`` its
counter), which holds ``serve.grow`` (the block tables' growth),
``serve.decode.launch`` (the host enqueuing the step's kernels),
``serve.decode.wait`` (the host blocked on the device for the tokens)
and ``serve.decode.emit`` (the hand-off and bookkeeping), or
``serve.verify`` for a verify round; with ``profile`` each span is a
``torch.profiler`` range of its name.  Each step's stamp is taken once
the host holds the step's tokens, so on the card it covers the device's
work, not only the launches.  The launch's two stamps also feed the
step-rate model the SLA schedule projects with (wall time when nothing
traces).

Dense-slot mode switches the prefix cache, the tiers and speculation off,
as the reference does.

Sharded serving (paged, ``cfg.mesh_shape``): one batcher per rank of a
process group of ``prod(mesh_shape)`` ranks, all fed the same requests.
Each holds its tiles of the parameters and pools
(``serve_loop.paged_sharding_specs`` / ``cut_tiles``: the model axis is
the last), replicated block tables and slot state, and runs the paged
steps under ``serve_loop._shard_wrap``; the allocator, prefix index,
tiers and drafter run on every rank alike, each rank's host tier holding
its own tiles (counted at full width, so every rank evicts alike).  Rank 0 takes the host decisions that depend on time or on what
a stream happens to hold (``serve.lockstep``), so every rank emits the
same streams and events.  As in the reference, the mesh is for the paged
path only: a config with no page layout (dense slots, ssm, hybrid)
serves unsharded on each rank.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.stream import Stream, StreamClosed
from ..models import params as PP
from ..models import registry
from ..models.cache_layouts import get_layout
from .kv_tiers import KVTierManager, SnapshotCorruptError, StagedTransferEngine
from .lockstep import Lockstep, LockstepError
from .prefix_cache import PageAllocator, PrefixIndex
from .resilience import (BatcherFault, FaultPlan, InjectedFault,
                         StallFault, TerminalEvent, class_rank)
# re-exported: ``drain``'s callers catch ``RequestFailed`` from here.
from .resilience import RequestFailed  # noqa: F401
from .serve_loop import (advance_slots, cut_tiles, local_decls,
                         make_chunk_prefill_step, make_paged_decode_step,
                         make_spec_verify_step, mesh_coords,
                         paged_sharding_specs, serving_mesh_for)
from .telemetry import ServeTelemetry

_MIN_BUCKET = 8            # smallest prefill bucket (pad-to-power-of-two)
_MIN_CHUNK = 16            # smallest auto-selected prefill chunk


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --- step factories (dense-slot mode) --------------------------------------------------


def _make_step_fn(cfg: ModelConfig, max_seq: int):
    """Decode step over all dense slots: one batched forward in which
    every slot decodes at its own position (the reference vmaps a
    single-slot forward).  ``step(params, cache, last_tok, pos, remaining,
    active)`` returns ``(cache, last_tok, pos, remaining, active, out)``,
    the cache written in place.  Inactive slots run too; what they write
    is replaced when the slot is next admitted.  Each slot's MoE tokens
    have their own capacity (``row_capacity``), so an idle slot never
    takes a live slot's expert place."""

    def step_fn(params, cache, last_tok, pos, remaining, active):
        logits, cache = registry.forward(
            cfg, params, {"tokens": last_tok[:, None].long()}, mode="decode",
            cache=cache, pos=pos, row_capacity=True)
        return (cache,) + advance_slots(logits, last_tok, pos, remaining,
                                        active, max_seq)

    return step_fn


def _make_admit_fn(cfg: ModelConfig, max_seq: int):
    """Batched padded prefill + scatter into the slots.

    ``admit(params, cache, last_tok, pos, remaining, active, prompts,
    lens, rows, slots, max_new)``: ``prompts`` (n_rows, bucket) and
    ``lens``/``max_new`` (n_rows,) on the device; prefill row
    ``rows[j]`` lands in slot ``slots[j]``.  The reference scatters every
    row and drops the unplaced ones through the slot id ``n_slots``; here
    only the placed rows are written (a masked write, no drop-mode
    scatter).  Every row's MoE tokens have their own capacity, as under
    the reference's vmap.  Returns the updated state and ``tok0``
    (n_rows,) int32."""

    def admit_fn(params, cache, last_tok, pos, remaining, active, prompts,
                 lens, rows, slots, max_new):
        logits, cache1 = registry.forward(
            cfg, params, {"tokens": prompts.long()}, mode="prefill",
            cache_len=max_seq, last_pos=lens - 1, row_capacity=True)
        tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
        _scatter_rows(cache, cache1, rows, slots,
                      2 if cfg.local_global_pattern else 1)
        lens, max_new = lens[rows], max_new[rows]
        last_tok[slots] = tok0[rows]
        pos[slots] = lens
        remaining[slots] = max_new - 1
        active[slots] = (max_new > 1) & (lens < max_seq - 1)
        return cache, last_tok, pos, remaining, active, tok0

    return admit_fn


def _scatter_rows(cache, cache1, rows, slots, axis: int) -> None:
    """Write prefill rows ``rows`` of every leaf of ``cache1`` into slots
    ``slots`` of the same leaf of ``cache``, in place.  Every leaf of a
    dense slot cache has its slot axis at ``axis``: 1 for attention K/V
    and recurrent conv/ssd state (nested for hybrid), 2 for gemma3's
    (G, per_kind)-stacked local and global K/V."""
    lead = (slice(None),) * axis
    for name, c in cache.items():
        if isinstance(c, dict):
            _scatter_rows(c, cache1[name], rows, slots, axis)
        else:
            c[lead + (slots,)] = cache1[name][lead + (rows,)]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int
    priority: int = 0            # higher = preempted later
    # SLA lifecycle (serve.resilience): the class maps onto preemption
    # rank (latency > standard > batch) and, with schedule="sla",
    # admission order; ``deadline_ms`` is wall time from submit() after
    # which the request is expired (queued) or cancelled (in flight).
    klass: str = "standard"      # "latency" | "standard" | "batch"
    deadline_ms: Optional[float] = None
    submitted_at: float = 0.0    # stamped by submit() / first pop
    out: Stream = dataclasses.field(
        default_factory=lambda: Stream(depth=4096, name="resp"))


@dataclasses.dataclass
class _Admission:
    """A request mid-chunked-prefill: owns a slot + pages, not decoding.
    ``start`` is the first prompt position the catch-up prefill computes
    (0 for a cold request); ``cache_offset`` the read-only boundary below
    which the slot's pages are shared with the prefix cache (the matched
    token count).  ``resume`` marks a recompute-mode resume: the final
    chunk pushes no first token (it was emitted before the preemption),
    restores the parked decode budget and arms the suppressed-output
    replay of the already-emitted tokens."""
    req: Request
    slot: int
    plen: int
    next_chunk: int
    n_chunks: int
    start: int = 0
    cache_offset: int = 0
    resume: Optional["_Preempted"] = None


@dataclasses.dataclass
class _Preempted:
    """A preempted decode: its KV pages parked on the host, slot released.
    ``pos``/``last_tok``/``remaining`` mirror the slot's device state at
    preemption; ``data``/``counts`` hold the spilled *private* pages per
    group.  ``shared`` lists the leading prefix-cache pages the slot
    still references: never spilled (immutable while shared), the record
    keeps the slot's references and resume re-attaches them.  ``hist`` is
    the slot's token history, parked for the drafter.

    ``mode == "recompute"`` (tiered memory below ``tier_restore_min``, a
    failed spill or restore, or crash recovery): nothing was spilled;
    resume re-admits the prompt (prefix hits recover surviving blocks)
    and replays the ``pos - plen`` emitted decode steps with output
    pushes suppressed, so the cache bits and every later token equal the
    uncontended run.  ``skip`` counts replay pushes still owed
    suppression when the slot was preempted mid-replay."""
    req: Request
    pos: int
    last_tok: int
    remaining: int
    data: Dict[str, Any]
    counts: Dict[str, int]
    seq: int                     # admission order (preemption tie-break)
    shared: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    mode: str = "restore"        # "restore" (spilled pages) | "recompute"
    skip: int = 0
    hist: List[int] = dataclasses.field(default_factory=list)


# one scratch record of a verify span: (group, logical page, table entry,
# old physical page or None, scratch page).
_Swap = Tuple[str, int, int, Optional[int], int]


class ContinuousBatcher:
    """Fixed-slot continuous batcher over dense slots or paged KV, with
    device-resident slot state.  ``paged`` says which mode runs: paged
    when a page size is given (or the config's ``kv_page_size``) and the
    family has a pageable layout, dense slots otherwise.  ``device`` is
    where the caches and slot state live; the parameters must already be
    there.  ``reserve_decode``, ``prefix_cache``, ``prefix_block``,
    ``prefill_exact``, ``host_tier_bytes``, ``tier_snapshot``,
    ``tier_restore_min``, ``schedule``, ``overload`` and ``queue_depth``
    override the config's fields of those names; ``faults`` is a
    ``FaultPlan`` or its spec (then ``REPRO_FAULTS``, then
    ``cfg.fault_plan``); ``telemetry`` a ``ServeTelemetry`` that takes
    the lifecycle events and histograms.  ``clock`` is the one time base
    of deadlines, transfer timings and telemetry: an explicit ``clock``,
    else the telemetry's, else wall time."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_seq: int, n_pages=None,
                 page_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_interleave: Optional[int] = None,
                 reserve_decode: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_block: Optional[int] = None,
                 prefill_exact: Optional[bool] = None,
                 host_tier_bytes: Optional[int] = None,
                 tier_snapshot: Optional[str] = None,
                 tier_restore_min: Optional[int] = None,
                 schedule: Optional[str] = None,
                 overload: Optional[str] = None,
                 queue_depth: Optional[int] = None,
                 faults=None,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry: Optional[ServeTelemetry] = None,
                 transfer_retries: int = 2,
                 tier_fault_limit: int = 3,
                 device="cuda"):
        # paligemma and musicgen generate through serve_loop's
        # greedy_generate; the batcher refuses them, as the reference's
        # does (its requests carry no image or conditioning).
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError("batcher demo covers LM families")
        psz = int(page_size or cfg.kv_page_size)
        self.layout = get_layout(cfg, psz) if psz else None
        self.paged = self.layout is not None
        self.cfg, self.params = cfg, params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        # sharded serving (paged only): the serving mesh, its model
        # group and the lockstep of host decisions; None on one process.
        self.mesh = None
        self._group = None
        self._lock: Optional[Lockstep] = None
        # resilience: deterministic fault plan, SLA scheduling knobs,
        # explicit bounded-queue overload policy, one time base.
        self._fault: FaultPlan = FaultPlan.resolve(faults, cfg.fault_plan)
        self.schedule = str(schedule or cfg.serve_schedule)
        if self.schedule not in ("fifo", "sla"):
            raise ValueError(f"schedule must be fifo|sla, got "
                             f"{self.schedule!r}")
        self.overload = str(overload or cfg.serve_overload)
        if self.overload not in ("block", "reject"):
            raise ValueError(f"overload must be block|reject, got "
                             f"{self.overload!r}")
        qd = int(cfg.serve_queue_depth if queue_depth is None
                 else queue_depth)
        # one time base for scheduling and telemetry: an explicit clock
        # wins, then the telemetry's (a fake-clocked ServeTelemetry makes
        # the whole batcher deterministic), then wall time; the telemetry
        # is re-bound to the choice.
        if clock is not None:
            self._clock = clock
        elif telemetry is not None:
            self._clock = telemetry.clock
        else:
            self._clock = time.monotonic
        self._telemetry = telemetry
        # the host spans' tracer (``ServeTelemetry.spans``): None unless
        # the telemetry traces or profiles.
        self._tracer = telemetry.spans if telemetry is not None else None
        if telemetry is not None:
            telemetry.bind_clock(self._clock)
            telemetry.add_collector(self._sync_telemetry)
        self.requests: Stream = Stream(depth=qd or 2 * n_slots,
                                       name="requests")
        # lifecycle counters; ``rejections`` is keyed by the typed
        # rejection reason a consumer sees in its RequestRejected.
        self.rejections: Dict[str, int] = {}
        self.expired = 0
        self.errored = 0
        self.cancelled = 0
        self.tier_faults = 0
        self.tier_disabled = False
        self.restarts = 0
        self.snapshot_cold_start = False
        self.transfer_retries = int(transfer_retries)
        self.tier_fault_limit = int(tier_fault_limit)
        self._ewma_step_s = 0.0      # smoothed decode-step wall time
        self._ewma_step_tok = 0.0    # smoothed tokens retired per step
        # decode steps since the last prefill chunk (``run``'s
        # interleave of chunks and steps).
        self._decodes_since_chunk = 0
        # supervisor wiring (ServeSupervisor sets these).
        self._heartbeat = None
        self._supervised = False
        self._stalled = False
        # any request in the system carrying a deadline? (keeps the
        # per-step expiry sweep off the hot path when nobody uses them)
        self._deadlines_live = False
        self.recompute_resumes = 0
        self.steps = 0
        self.retired = 0
        self.prefill_chunks = 0
        self.preemptions = 0
        self.resumes = 0
        self.peak_pages = 0
        self.preempted_rids: List[int] = []
        # prefix-cache and speculation counters (stats(); zero when off).
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rolled_back = 0
        self.spec_verify_steps = 0
        # dense slots: no shared pages, no tiers and no block tables to
        # roll back.
        self.prefix_cache = False
        self._prefix: Optional[PrefixIndex] = None
        self._tiers: Optional[KVTierManager] = None
        self._xfer: Optional[StagedTransferEngine] = None
        self.speculate_k = 0

        # host mirror: which Request occupies each decoding slot.
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        # requests popped from the FIFO but not yet placed (backpressure).
        self._pending: Deque[Request] = collections.deque()
        # paged-only scheduling state; stays empty in dense-slot mode.
        self._alloc: Dict[str, PageAllocator] = {}
        self._admitting: Deque[_Admission] = collections.deque()
        self._preempted: List[_Preempted] = []

        # device-resident slot state.
        i32 = torch.int32
        self.last_tok = torch.zeros((n_slots,), dtype=i32, device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=i32, device=self.device)
        self.remaining = torch.zeros((n_slots,), dtype=i32,
                                     device=self.device)
        self.active = torch.zeros((n_slots,), dtype=torch.bool,
                                  device=self.device)
        # host mirrors of per-slot decode state (drive lazy growth and
        # preemption without device readbacks).
        self._host_pos = [0] * n_slots
        self._host_last_tok = [0] * n_slots
        self._host_remaining = [0] * n_slots
        # decode steps left to replay with output pushes suppressed
        # (recompute-mode resume re-emits already-delivered tokens).
        self._replay_skip = [0] * n_slots

        if not self.paged:
            self.cache = PP.init_params(
                registry.cache_decls(cfg, n_slots, max_seq),
                device=self.device)
            self._step = _make_step_fn(cfg, max_seq)
            self._admit_fn = _make_admit_fn(cfg, max_seq)
            return
        self.page_size = psz
        if cfg.mesh_shape:
            self._shard(params)
        self.reserve_decode = bool(
            cfg.kv_reserve_decode if reserve_decode is None
            else reserve_decode)
        self.n_blocks = {g.name: self.layout.n_blocks(g.name, max_seq)
                         for g in self.layout.groups}
        # default pool = dense-equivalent capacity.
        dense_eq = {name: n_slots * nb for name, nb in self.n_blocks.items()}
        if n_pages is None:
            self.n_pages = dense_eq
        elif isinstance(n_pages, dict):
            self.n_pages = {**dense_eq,
                            **{k: int(v) for k, v in n_pages.items()}}
        else:
            # an int applies to every growing group; a window-bounded
            # ring group never needs more than n_slots * n_blocks pages.
            self.n_pages = {
                g.name: (min(int(n_pages), dense_eq[g.name]) if g.ring
                         else int(n_pages))
                for g in self.layout.groups}
        self.chunk = int(prefill_chunk or cfg.prefill_chunk
                         or max(self.page_size, _MIN_CHUNK))
        self.prefill_interleave = int(
            cfg.prefill_interleave if prefill_interleave is None
            else prefill_interleave)
        self._alloc = {name: PageAllocator(n)
                       for name, n in self.n_pages.items()}
        self._slot_pages: Dict[str, List[List[int]]] = {
            name: [[] for _ in range(n_slots)] for name in self.n_pages}
        # leading run of each slot's pages still shared with the prefix
        # cache (a write there copies the page first).
        self._slot_nshared: Dict[str, List[int]] = {
            name: [0] * n_slots for name in self.n_pages}
        self.prefill_exact = bool(
            cfg.prefill_exact if prefill_exact is None else prefill_exact)
        self.prefix_block = int(prefix_block or cfg.prefix_block
                                or self.page_size)
        want_prefix = bool(cfg.prefix_cache if prefix_cache is None
                           else prefix_cache)
        # sharing needs EVERY page group shareable.
        self.prefix_cache = want_prefix and self.layout.prefix_shareable
        if self.prefix_cache:
            self._prefix = PrefixIndex([g.name for g in self.layout.groups],
                                       self.page_size, self.prefix_block)
        # Tiered KV memory: ONE staged-transfer engine carries every
        # device<->host page movement (preemption spill/resume and the
        # host tier's demote/promote); the T1 store only exists with a
        # byte budget AND the prefix cache (demotion is keyed by the
        # prefix index's token paths).
        self._xfer = StagedTransferEngine(self.layout, faults=self._fault,
                                          clock=self._clock,
                                          telemetry=telemetry,
                                          group=self._group)
        self.tier_restore_min = int(
            cfg.tier_restore_min_tokens if tier_restore_min is None
            else tier_restore_min)
        htb = int(cfg.kv_host_tier_bytes if host_tier_bytes is None
                  else host_tier_bytes)
        self.host_tier_bytes = htb if self.prefix_cache else 0
        if self.host_tier_bytes > 0:
            self._tiers = KVTierManager(self.layout, self.page_size,
                                        self.prefix_block,
                                        self.host_tier_bytes, self._xfer)
        self.tier_snapshot = str(
            cfg.kv_tier_snapshot if tier_snapshot is None
            else tier_snapshot) if self._tiers is not None else ""
        if self.tier_snapshot and os.path.exists(self.tier_snapshot):
            try:
                self._tiers.load(self.tier_snapshot)
            except SnapshotCorruptError as e:
                # storage rot is an availability event, not a config
                # error: log it and serve cold.  (A geometry mismatch,
                # ValueError, still raises: the snapshot is intact but
                # belongs to another layout.)
                warnings.warn(f"kv tier snapshot unusable, serving "
                              f"from cold start: {e}")
                self.snapshot_cold_start = True
        self.pools = self._new_pools()
        # invalid page id == n_pages[group]: reads clamp (and are masked),
        # writes are masked out.
        self.block_tab = {
            name: torch.full((n_slots, self.n_blocks[name]),
                             self.n_pages[name], dtype=i32,
                             device=self.device)
            for name in self.n_pages}
        self._slot_seq = [0] * n_slots
        self._admit_seq = 0
        self._step = make_paged_decode_step(cfg, max_seq, self.page_size)
        self._chunk_fn = make_chunk_prefill_step(cfg, self.chunk, max_seq,
                                                 self.page_size)
        # speculative decode.  The history and acceptance state exist
        # even at k = 0, so the bookkeeping paths stay branch-free.
        self.speculate_k = max(int(cfg.speculate_k), 0)
        self.speculate_ngram = max(int(cfg.speculate_ngram), 1)
        self.speculate_min_accept = float(cfg.speculate_min_accept)
        self.speculate_probe = max(int(cfg.speculate_probe), 0)
        self._history: List[List[int]] = [[] for _ in range(n_slots)]
        self._accept_ewma = [1.0] * n_slots
        # re-probe schedule of self-disabled drafter slots: the next step
        # allowed to probe, and the (exponentially backed-off) gap.
        self._probe_at = [0] * n_slots
        self._probe_gap = [0] * n_slots
        # per-slot n-gram position index (ngram -> sorted positions of
        # its occurrences in the history), extended incrementally
        # (_ng_done = positions indexed so far): a draft lookup costs
        # O(log occurrences), not a backward scan of the history.
        self._ng_idx: List[Dict[Tuple[int, ...], List[int]]] = \
            [{} for _ in range(n_slots)]
        self._ng_done = [0] * n_slots
        if self.speculate_k:
            self._verify = make_spec_verify_step(
                cfg, self.speculate_k + 1, max_seq, self.page_size)

    # -- sharded serving -------------------------------------------------------------

    def _shard(self, params) -> None:
        """Join the serving mesh of ``cfg.mesh_shape`` over the default
        process group: keep this rank's tiles of ``params`` (the whole
        weights, cut here, or the tiles ``serve_loop.init_tiles`` made,
        kept as they are), remember the pools' specs, and follow rank 0's
        host decisions when there is more than one rank."""
        import torch.distributed as dist
        self.mesh, axis = serving_mesh_for(self.cfg)
        self._group = self.mesh.get_group(axis)
        self._sizes, coords = mesh_coords(self.mesh)
        p_specs, self._pool_specs = paged_sharding_specs(
            self.cfg, self.page_size, self._sizes)
        tiles = local_decls(registry.decls(self.cfg), p_specs, self._sizes)
        if not all(PP.tree_leaves(PP.tree_map(
                lambda path, d: tuple(PP.tree_at(params, path).shape)
                == tuple(d.shape), tiles))):
            params = cut_tiles(params, p_specs, self._sizes, coords)
        self.params = params
        if dist.get_world_size() > 1:
            self._lock = Lockstep(shed=self.overload == "reject")

    def _new_pools(self):
        """Zeroed page pools: this rank's tiles of them on a mesh."""
        decls = registry.paged_cache_decls(self.cfg, self.n_pages,
                                           self.page_size)
        if self.mesh is not None:
            decls = local_decls(decls, self._pool_specs, self._sizes)
        return PP.init_params(decls, device=self.device)

    def _try_pop(self) -> Optional[Request]:
        """The request stream's ``TryPop``: rank 0's on a sharded serve."""
        if self._lock is not None:
            return self._follow(self._lock.try_pop)
        return self.requests.TryPop()

    def _follow(self, pop, *args) -> Optional[Request]:
        """``pop(self.requests, *args)`` of the lockstep.  A request this
        rank popped but could not follow rank 0 with is queued again, so
        ``fail_inflight`` gives it its outcome."""
        try:
            return pop(self.requests, *args)
        except LockstepError as e:
            if e.request is not None:
                self._pending.appendleft(e.request)
            raise

    def _now(self) -> float:
        """The clock reading host decisions use (deadlines, submit
        stamps): rank 0's, taken once per loop iteration, on a sharded
        serve."""
        if self._lock is None:
            return self._clock()
        if self._lock.now is None:
            self._tick()
        return self._lock.now

    def _tick(self) -> bool:
        """One iteration's shared inputs: the clock reading, the smoothed
        step time and the watchdog's stall flag, rank 0's on a sharded
        serve.  Returns the stall flag."""
        if self._lock is None:
            return self._stalled
        _, self._ewma_step_s, stalled = self._lock.tick(
            self._clock(), self._ewma_step_s, self._stalled)
        return stalled

    # -- shared helpers -------------------------------------------------------------

    def _next_request(self) -> Optional[Request]:
        if self._pending:
            r = self._pending.popleft()
        else:
            r = self._try_pop()
        if r is not None:
            if r.submitted_at == 0.0:      # direct Push (bypassed submit)
                r.submitted_at = self._now()
                if self._telemetry:
                    self._telemetry.note_submit(r)
            if r.deadline_ms is not None:
                self._deadlines_live = True
        return r

    def _fail_request(self, r: Request, event: TerminalEvent) -> None:
        """End a request with a typed in-band event pushed before the
        close, so its consumer's ``drain`` re-raises the cause instead of
        waiting out a timeout.  A full or closed stream degrades to
        close-only."""
        try:
            r.out.Push(event, timeout=1.0)
        except (TimeoutError, StreamClosed):
            pass
        r.out.close()
        if event.kind == "rejected":
            self.rejections[event.reason] = \
                self.rejections.get(event.reason, 0) + 1
        elif event.kind == "expired":
            self.expired += 1
        elif event.kind == "errored":
            self.errored += 1
        else:
            self.cancelled += 1
        if self._telemetry:
            self._telemetry.note_terminal(r.rid, event.kind, event.reason)

    def _reject(self, r: Request, reason: str = "unservable") -> None:
        """Unservable request (bypassed submit() validation, or needs more
        pages than the whole pool): typed rejection + close."""
        self._fail_request(r, TerminalEvent.rejected(r.rid, reason))
        self.retired += 1

    def _expiry_left_ms(self, r: Request) -> float:
        """Milliseconds of deadline budget left (+inf when none)."""
        if r.deadline_ms is None:
            return float("inf")
        return r.deadline_ms - (self._now() - r.submitted_at) * 1e3

    def total_used_pages(self) -> int:
        return sum(a.used_pages for a in self._alloc.values())

    def stats(self) -> Dict[str, Any]:
        """Scheduling and lifecycle counters; paged mode adds the ladder's
        counters, per-group pool occupancy, the shared-page and
        copy-on-write counts, the transfer engine's and speculation's
        counters and, with the prefix cache, its hit counters (and the
        tiers', when the host tier is on)."""
        s: Dict[str, Any] = {
            "paged": self.paged,
            "steps": self.steps, "retired": self.retired,
            "preemptions": self.preemptions, "resumes": self.resumes,
            "prefill_chunks": self.prefill_chunks,
            "peak_pages": self.peak_pages,
            "rejections": dict(self.rejections),
            "expired": self.expired, "errored": self.errored,
            "cancelled": self.cancelled,
        }
        if self._telemetry:
            # bucket-derived p50/p90/p99 per latency histogram: the
            # registry is the source, stats() a view.
            s["latency"] = self._telemetry.latency_summary()
        if not self.paged:
            return s
        s["tier_faults"] = self.tier_faults
        s["tier_disabled"] = self.tier_disabled
        s["restarts"] = self.restarts
        s["snapshot_cold_start"] = self.snapshot_cold_start
        s["transfers"] = self._xfer.stats()
        if self.mesh is not None:
            s["mesh"] = self._mesh_stats()
        s["pools"] = {name: {"free": a.free_pages, "used": a.used_pages,
                             "shared": a.shared_pages}
                      for name, a in self._alloc.items()}
        s["shared_pages"] = sum(a.shared_pages for a in self._alloc.values())
        s["cow_copies"] = self.cow_copies
        s["prefix_cache"] = self.prefix_cache
        # every accepted draft token is one decode step the slot skipped;
        # rolled_back counts draft tokens whose scratch KV was discarded.
        s["speculation"] = {
            "k": self.speculate_k,
            # the names the Prometheus surface exports; the bare names
            # beside them are the reference's aliases.
            "tokens_drafted": self.spec_drafted,
            "tokens_accepted": self.spec_accepted,
            "tokens_rolled_back": self.spec_rolled_back,
            "verify_rounds": self.spec_verify_steps,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "rolled_back": self.spec_rolled_back,
            "acceptance_rate": (self.spec_accepted
                                / max(self.spec_drafted, 1)),
            "verify_steps": self.spec_verify_steps,
            "decode_steps_saved": self.spec_accepted,
            "accept_ewma": list(self._accept_ewma),
        }
        if self._tiers is not None:
            s["tiers"] = {**self._tiers.stats(),
                          "recompute_resumes": self.recompute_resumes}
        if self.prefix_cache:
            s["prefix_lookups"] = self.prefix_lookups
            s["prefix_hits"] = self.prefix_hits
            s["prefix_hit_rate"] = (self.prefix_hits
                                    / max(self.prefix_lookups, 1))
            s["prefix_hit_tokens"] = self.prefix_hit_tokens
            s["prefix_evictions"] = self.prefix_evictions
            s["cached_prefixes"] = self._prefix.n_nodes
            s["cached_prefix_pages"] = self._prefix.n_pages
        return s

    def _mesh_stats(self) -> Dict[str, Any]:
        """The mesh, this rank's and the whole pool's bytes (the tp-fold
        drop of KV memory per device), this rank's weight bytes, and the
        collectives of a decode
        step counted from the model's shape: one sum per attention and
        one per MLP or MoE block, and, at tp > 1, the logits' gather and
        MLA's latent gather per layer."""
        cfg = self.cfg
        tp = int(cfg.mesh_shape[-1])
        full = registry.paged_cache_decls(cfg, self.n_pages, self.page_size)
        return {
            "shape": tuple(cfg.mesh_shape),
            "axes": tuple(self.mesh.mesh_dim_names),
            "tp": tp,
            "pool_bytes_per_shard": sum(
                t.numel() * t.element_size()
                for t in PP.tree_leaves(self.pools)),
            "pool_bytes_total": sum(
                int(np.prod(d.shape)) * d.dtype.itemsize
                for d in PP.tree_leaves(full)),
            "param_bytes_per_shard": sum(
                t.numel() * t.element_size()
                for t in PP.tree_leaves(self.params)),
            "collectives_per_decode_step": {
                "psum": 2 * cfg.n_layers,
                "all_gather": 0 if tp <= 1 else
                1 + (cfg.n_layers if cfg.mla else 0)},
        }

    def _sync_telemetry(self) -> None:
        """Collector: mirror the plain-attribute lifetime counters into
        the telemetry registry.  Runs on every registry read (scrape or
        snapshot), not per event, so the hot paths keep bumping plain
        ints."""
        tel = self._telemetry
        if tel is None:
            return
        m = tel.metrics
        c, g = m.counter, m.gauge
        c("serve_steps_total", "batched decode jit calls").set(self.steps)
        c("serve_retired_total", "requests fully finished (any outcome)"
          ).set(self.retired)
        c("serve_prefill_chunks_total", "chunked-prefill jit calls"
          ).set(self.prefill_chunks)
        c("serve_preemptions_total", "slots preempted").set(
            self.preemptions)
        c("serve_resumes_total", "preempted slots resumed").set(
            self.resumes)
        c("serve_expired_total", "requests expired past deadline"
          ).set(self.expired)
        c("serve_errored_total", "requests failed with an error").set(
            self.errored)
        c("serve_cancelled_total", "requests cancelled").set(
            self.cancelled)
        for reason, n in self.rejections.items():
            c("serve_rejections_total", "requests rejected, by reason",
              labels={"reason": reason}).set(n)
        g("serve_queue_depth", "requests waiting in the admission queue"
          ).set(len(self._pending) + self.requests.Size())
        g("serve_slots_live", "slots with an active request").set(
            sum(1 for r in self._slot_req if r is not None))
        if not self.paged:
            return
        c("serve_restarts_total", "supervised crash recoveries").set(
            self.restarts)
        c("serve_tier_faults_total", "injected/real tier-transfer faults"
          ).set(self.tier_faults)
        g("serve_peak_pages", "high-water mark of used pages").set(
            self.peak_pages)
        for name, a in self._alloc.items():
            for state, n in (("free", a.free_pages), ("used", a.used_pages),
                             ("shared", a.shared_pages)):
                g("serve_pool_pages", "page-pool occupancy by group/state",
                  labels={"group": name, "state": state}).set(n)
        c("serve_spec_tokens_drafted_total", "speculative tokens drafted"
          ).set(self.spec_drafted)
        c("serve_spec_tokens_accepted_total",
          "speculative tokens accepted (decode steps saved)").set(
            self.spec_accepted)
        c("serve_spec_tokens_rolled_back_total",
          "speculative tokens rolled back").set(self.spec_rolled_back)
        c("serve_spec_verify_rounds_total", "speculative verify rounds"
          ).set(self.spec_verify_steps)
        c("serve_transfer_gathers_total", "staged D2H gathers").set(
            self._xfer.gathers)
        c("serve_transfer_scatters_total", "staged H2D scatters").set(
            self._xfer.scatters)
        c("serve_transfer_d2h_bytes_total", "bytes spilled to host").set(
            self._xfer.d2h_bytes)
        c("serve_transfer_h2d_bytes_total", "bytes restored to device"
          ).set(self._xfer.h2d_bytes)
        if self.prefix_cache:
            c("serve_prefix_lookups_total", "prefix-cache lookups").set(
                self.prefix_lookups)
            c("serve_prefix_hits_total", "prefix-cache hits").set(
                self.prefix_hits)
            c("serve_prefix_hit_tokens_total",
              "prompt tokens served from cached prefixes").set(
                self.prefix_hit_tokens)
            c("serve_cow_copies_total", "copy-on-write page copies").set(
                self.cow_copies)
            c("serve_prefix_evictions_total", "prefix nodes evicted"
              ).set(self.prefix_evictions)
        if self._tiers is not None:
            t = self._tiers
            g("serve_t1_bytes", "host-tier resident bytes").set(
                t.store.nbytes)
            c("serve_t1_demotions_total", "prefix blocks demoted to T1"
              ).set(t.demotions)
            c("serve_t1_rehits_total", "T1 promote-back hits").set(
                t.rehits)
            c("serve_t1_recomputes_total",
              "tier misses recomputed from tokens").set(t.recomputes)

    # -- dense bucketed admission -------------------------------------------------------

    def _bucket_for(self, plen: int) -> int:
        """Pad-to-power-of-two bucket for a prompt length (at least
        ``_MIN_BUCKET``, at most ``max_seq``).  Attention caches are safe
        for any bucket: padded positions are masked, or (sliding window)
        kept out of the ring by the mask-aware emission.  Recurrent
        families (ssm/hybrid) take the exact length: their conv and SSD
        state reduce over the whole padded sequence, so padding would
        corrupt the state itself."""
        if self.cfg.family in ("ssm", "hybrid"):
            return plen
        return min(max(_MIN_BUCKET, _next_pow2(plen)), self.max_seq)

    def _admit_batch(self, pairs) -> None:
        """Admit (slot, request) pairs: one padded prefill per bucket, at
        ``n_slots`` rows (unused rows are zero prompts that are never
        written), as the reference does."""
        groups: Dict[int, list] = {}
        for slot, r in pairs:
            if len(r.prompt) >= self.max_seq:
                self._reject(r)    # bypassed submit() validation
                continue
            groups.setdefault(self._bucket_for(len(r.prompt)),
                              []).append((slot, r))
        dev = self.device
        for bucket, grp in groups.items():
            prompts = np.zeros((self.n_slots, bucket), np.int32)
            lens = np.ones((self.n_slots,), np.int32)
            max_new = np.ones((self.n_slots,), np.int32)
            for row, (slot, r) in enumerate(grp):
                prompts[row, :len(r.prompt)] = r.prompt
                lens[row] = len(r.prompt)
                max_new[row] = r.max_new
            rows = torch.arange(len(grp), device=dev)
            slots = torch.as_tensor([slot for slot, _ in grp], device=dev)
            (self.cache, self.last_tok, self.pos, self.remaining,
             self.active, tok0) = self._admit_fn(
                self.params, self.cache, self.last_tok, self.pos,
                self.remaining, self.active, torch.from_numpy(prompts).to(dev),
                torch.from_numpy(lens).to(dev), rows, slots,
                torch.from_numpy(max_new).to(dev))
            tok0 = tok0.cpu().numpy()
            tel = self._telemetry
            for row, (slot, r) in enumerate(grp):
                r.out.Push(int(tok0[row]))
                if tel:
                    tel.note_first_token(r.rid, slot, tel.clock(),
                                         pos=len(r.prompt))
                if r.max_new > 1 and len(r.prompt) < self.max_seq - 1:
                    self._slot_req[slot] = r
                else:                          # retired at admission
                    r.out.close()
                    self.retired += 1
                    if tel:
                        tel.note_retire(r.rid, slot)

    # -- paged admission (chunked prefill, prefix hits) ------------------------------

    def _full_pages_needed(self, r: Request, group: str) -> int:
        """Worst-case pages the request can ever hold in this group."""
        total = min(len(r.prompt) + r.max_new, self.max_seq)
        return self.layout.blocks_for(group, total, self.max_seq)

    def _admit_pages_needed(self, r: Request, group: str,
                            cover: Optional[int] = None) -> int:
        """Pages reserved at admission: the prompt's under lazy growth,
        the worst case under ``reserve_decode``.  ``cover`` raises the
        floor to a token position (a recompute-mode resume reserves
        through ``pos + 1`` so the re-admitted slot can replay and emit
        at least one token before it can be preempted again, the
        headroom rule of the restore path)."""
        if self.reserve_decode:
            return self._full_pages_needed(r, group)
        tokens = max(len(r.prompt), cover or 0)
        return self.layout.blocks_for(group, tokens, self.max_seq)

    def _set_table_row(self, group: str, slot: int, pages: List[int]) -> None:
        row = np.full((self.n_blocks[group],), self.n_pages[group], np.int32)
        row[:len(pages)] = pages
        self.block_tab[group][slot] = torch.from_numpy(row).to(self.device)

    def _note_peak(self) -> None:
        self.peak_pages = max(self.peak_pages, self.total_used_pages())

    def _tier_op(self, what: str, fn: Callable[[], Any],
                 backoff: float = 0.005) -> Tuple[bool, Any]:
        """Run a tier transfer with capped-backoff retries — rung 1 of
        the degradation ladder.  Returns ``(ok, result)``; on final
        failure the caller falls through to its recompute path (rung 2),
        and after ``tier_fault_limit`` failed operations the host tier is
        disabled (rung 3, tier-off).  Only ``RuntimeError`` (which
        includes ``InjectedFault``) is retried: anything else is a bug
        and propagates."""
        err: Optional[BaseException] = None
        for attempt in range(self.transfer_retries + 1):
            if attempt:
                time.sleep(min(backoff * (2 ** (attempt - 1)), 0.05))
            try:
                return True, fn()
            except RuntimeError as e:
                err = e
        self.tier_faults += 1
        warnings.warn(f"tier {what} failed after "
                      f"{self.transfer_retries + 1} attempts: {err}")
        if (self.tier_faults >= self.tier_fault_limit
                and self._tiers is not None):
            self._tiers = None
            self.tier_disabled = True
            warnings.warn(f"host KV tier disabled after "
                          f"{self.tier_faults} transfer faults "
                          f"(degraded to recompute-only)")
        return False, None

    def _alloc_evict(self, name: str, n: int) -> Optional[List[int]]:
        """Alloc ``n`` pages, evicting LRU cached prefixes under pressure.
        Cached prefixes are worth less than any live request, so they are
        released (decref'd: pages still shared by live slots survive
        through those references) before admission backpressures or any
        live slot is preempted.  With the host tier, each evicted node's
        payload is demoted to T1 first, while its pages are still live."""
        if self._fault.fire("alloc"):
            # simulated pool exhaustion: the caller takes its dry-pool
            # path (backpressure / preemption).
            return None
        got = self._alloc[name].alloc(n)
        while got is None and self._prefix is not None \
                and self._prefix.n_nodes:
            evicted = self._prefix.evict_lru()
            if evicted is None:
                break
            path_toks, pages = evicted
            if self._tiers is not None:
                # a failed demote only loses the T1 copy; the eviction
                # proceeds (a rehit will recompute).
                self._tier_op("demote", lambda: self._tiers.demote(
                    path_toks, pages, self.pools))
            for gname, pgs in pages.items():
                self._alloc[gname].free(pgs)
            self.prefix_evictions += 1
            got = self._alloc[name].alloc(n)
        return got

    def _tier_promote(self, prompt: np.ndarray) -> int:
        """Restore the longest T1 block chain the device index is missing
        for this prompt: allocate pages per group, scatter the host
        payloads back in one staged transfer, and insert the blocks into
        the ``PrefixIndex``, so the admission's match attaches them like
        any cached prefix.  Returns tokens promoted.  Chains shorter than
        ``tier_restore_min`` recompute instead.  Allocation pressure can
        evict blocks of this very prompt (demoting them); the promote
        then re-anchors against the new tree state."""
        tiers = self._tiers
        for _ in range(2):
            nb = self._prefix.matched_blocks(prompt)
            chain = tiers.match(prompt, start_block=nb)
            if not chain:
                return 0
            if len(chain) * tiers.block < self.tier_restore_min:
                tiers.recomputes += 1
                return 0
            bpp = tiers.bpp
            new_pages: Dict[str, List[int]] = {g.name: []
                                               for g in self.layout.groups}
            taken = 0
            for _entry in chain:                 # leading blocks, best effort
                grabbed: Dict[str, List[int]] = {}
                ok = True
                for g in self.layout.groups:
                    got = self._alloc_evict(g.name, bpp)
                    if got is None:
                        ok = False
                        break
                    grabbed[g.name] = got
                if not ok:
                    for gname, pgs in grabbed.items():
                        self._alloc[gname].free(pgs)
                    break
                for gname in new_pages:
                    new_pages[gname].extend(grabbed[gname])
                taken += 1
            if not taken or taken * tiers.block < self.tier_restore_min:
                # nothing allocatable, or pool pressure cut the chain
                # below the recompute crossover.
                for gname, pgs in new_pages.items():
                    if pgs:
                        self._alloc[gname].free(pgs)
                if taken:
                    tiers.recomputes += 1
                return 0
            if self._prefix.matched_blocks(prompt) != nb:
                # our own allocation pressure evicted on-path blocks;
                # hand the pages back and re-anchor (they are in T1 now).
                for gname, pgs in new_pages.items():
                    if pgs:
                        self._alloc[gname].free(pgs)
                continue
            ok, pools = self._tier_op(
                "promote", lambda: tiers.restore_chain(
                    self.pools, chain[:taken], new_pages))
            if not ok:
                # promotion failed: hand the pages back and recompute
                # (rung 2).
                for gname, pgs in new_pages.items():
                    if pgs:
                        self._alloc[gname].free(pgs)
                tiers.recomputes += 1
                return 0
            self.pools = pools
            total = (nb + taken) * tiers.block
            # blocks below nb already exist in the tree: insert walks past
            # them and absorbs only ours, so their placeholder ids (-1)
            # are never read, freed or written to a table.
            pages_arg = {gname: [-1] * (nb * bpp) + pgs
                         for gname, pgs in new_pages.items()}
            absorbed = set(self._prefix.insert(
                np.asarray(prompt[:total], np.int32), pages_arg))
            assert all(i >= nb * bpp for i in absorbed)
            dup = [i for i in range(nb * bpp, (nb + taken) * bpp)
                   if i not in absorbed]
            for gname in new_pages:              # defensive: racing insert
                pgs = [pages_arg[gname][i] for i in dup]
                if pgs:
                    self._alloc[gname].free(pgs)
            tiers.rehits += 1
            tiers.rehit_tokens += taken * tiers.block
            return taken * tiers.block
        return 0

    def _try_admit_paged(self, r: Request, slot: int,
                         resume: Optional[_Preempted] = None) -> bool:
        """Reserve the prompt's pages + a slot and start chunked prefill.
        Returns False (leaving ``r`` to the caller) when any group's pool
        is dry — all-or-nothing across page groups.

        With the prefix cache the prompt is first matched against the
        ``PrefixIndex``: the matched span's pages are attached (incref,
        shared read-only) instead of allocated, and the catch-up prefill
        starts at the chunk-grid point at or below the divergence — a
        fully cached prompt prefills one chunk.  A partially matched page
        on the divergence boundary is copied (copy-on-write) into the
        first private page when the catch-up prefill will write past the
        match, or under ``reserve_decode``, when decode will (it never
        reaches ``_grow_slot``'s copy-on-write).  With the host tier, T1
        blocks missing from the index are promoted first, so the match
        sees them.

        ``resume`` re-admits a recompute-mode preempted request: the same
        path (prefix hits on its own blocks included), but the final
        chunk restores the parked decode budget and arms the
        suppressed-output replay instead of emitting a first token."""
        plen = len(r.prompt)
        m = 0
        shared: Dict[str, List[int]] = {g.name: [] for g in self.layout.groups}
        if self.prefix_cache:
            self.prefix_lookups += 1
            prompt_i32 = np.asarray(r.prompt, np.int32)
            if self._tiers is not None:
                self._tier_promote(prompt_i32)
            m, shared = self._prefix.match(prompt_i32)
        n_matched = _ceil_div(m, self.page_size)
        cow = bool(m % self.page_size) and (m < plen or self.reserve_decode)
        n_attach = n_matched - (1 if cow else 0)
        # Pin the matched pages BEFORE anything can evict: _alloc_evict
        # below may evict the very nodes just matched, and without this
        # reference their pages could come straight back as this
        # request's private pages, aliasing the prefix it reads.  The pin
        # is the slot's reference on the attached pages; the CoW source's
        # is dropped again after the copy.
        pinned = {name: pgs[:n_matched] for name, pgs in shared.items()}
        for name, pgs in pinned.items():
            if pgs:
                self._alloc[name].incref(pgs)
        grabbed: Dict[str, List[int]] = {}
        for g in self.layout.groups:
            need = self._admit_pages_needed(
                r, g.name, cover=(resume.pos + 1) if resume else None)
            if g.shareable:
                need -= n_attach
            pages = self._alloc_evict(g.name, max(need, 0))
            if pages is None:
                for name, pgs in grabbed.items():
                    self._alloc[name].free(pgs)
                for name, pgs in pinned.items():
                    if pgs:
                        self._alloc[name].free(pgs)
                return False
            grabbed[g.name] = pages
        for g in self.layout.groups:
            name = g.name
            attach = shared[name][:n_attach] if g.shareable else []
            if cow and shared[name][n_attach:]:
                # divergence mid-page: duplicate the boundary page into the
                # first private page before any differing write.
                self.layout.copy_pages(self.pools, name,
                                       shared[name][n_attach:n_attach + 1],
                                       grabbed[name][:1])
            if pinned[name][n_attach:]:            # unpin the CoW source
                self._alloc[name].free(pinned[name][n_attach:])
            row = attach + grabbed[name]
            self._set_table_row(name, slot, row)
            self._slot_pages[name][slot] = list(row)
            self._slot_nshared[name][slot] = len(attach)
        if cow:
            self.cow_copies += 1
        if m:
            self.prefix_hits += 1
            self.prefix_hit_tokens += m
        self._note_peak()
        # The catch-up prefill starts at the CHUNK-GRID point at or below
        # the divergence: its chunks then cover exactly the spans a cold
        # run covers, reading the same pool bytes, and since a shared
        # page's bits depend only on the matched tokens, a hit is
        # bit-identical to a cold run.  Positions in [start, m) are
        # recomputed as queries, their writes suppressed (cache_offset).
        start = min(m, plen - 1)
        start -= start % self.chunk
        if resume is None:
            self._slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
        else:                  # keep the original admission order (victim
            self._slot_seq[slot] = resume.seq      # tie-breaks stay stable)
        n_chunks = max(1, _ceil_div(plen - start, self.chunk))
        self._admitting.append(_Admission(
            req=r, slot=slot, plen=plen, next_chunk=0, n_chunks=n_chunks,
            start=start, cache_offset=m, resume=resume))
        if self._telemetry:
            self._telemetry.note_admit(
                r, slot, prefix_hit_tokens=m, cow=cow, start=start,
                n_chunks=n_chunks, resume=resume is not None)
        return True

    def _prefill_step(self) -> None:
        """One chunk of the oldest mid-admission request
        (``_prefill_chunk``), inside the ``serve.prefill_chunk`` span
        when tracing."""
        tr = self._tracer
        if tr is None:
            return self._prefill_chunk()
        with tr.open("serve.prefill_chunk", owner=self._admitting[0].req.rid,
                     number=self.prefill_chunks):
            return self._prefill_chunk()

    def _prefill_chunk(self) -> None:
        """Run ONE chunk of the oldest mid-admission request.  Chunks
        cover ``[start + c*chunk, ...)``.  ``prefill_exact`` swaps the
        final chunk for one pow2-bucketed pass over the whole remaining
        span ``[start, plen)``, so every prompt position's K/V is
        recomputed with full-precision own-chunk attention and the
        installed cache does not depend on the chunking.

        A request whose deadline passed, or whose chunk takes an injected
        ``chunk`` fault (checked before the call touches the pools), ends
        alone with a typed event; a genuine failure inside the call is
        fatal (``BatcherFault``)."""
        a = self._admitting[0]
        if self._deadlines_live and self._expiry_left_ms(a.req) <= 0:
            self._admitting.popleft()
            self._fail_request(a.req, TerminalEvent.expired(
                a.req.rid, "deadline passed during prefill"))
            self._release_slot(a.slot)
            self.retired += 1
            return
        try:
            self._fault.check("chunk")
        except InjectedFault as e:
            self._admitting.popleft()
            self._fail_request(a.req, TerminalEvent.errored(a.req.rid, e))
            self._release_slot(a.slot)
            self.retired += 1
            return
        C, c = self.chunk, a.next_chunk
        final = c == a.n_chunks - 1
        base = a.start + c * C
        fn = self._chunk_fn
        if final and self.prefill_exact:
            base = a.start
            C = max(_next_pow2(a.plen - base), _MIN_CHUNK)
            fn = make_chunk_prefill_step(self.cfg, C, self.max_seq,
                                         self.page_size)
        seg = np.zeros((1, C), np.int32)
        part = np.asarray(a.req.prompt[base:base + C], np.int32)
        seg[0, :len(part)] = part
        last_in_chunk = (a.plen - 1 - base) if final else (C - 1)
        dev = self.device
        # a resume needs no special budget: pos + remaining == plen +
        # max_new - 1 at every step, so installing max_new - 1 again
        # leaves exactly (replay steps + parked remaining) on the device.
        tel = self._telemetry
        t0 = tel.clock() if tel else 0.0
        try:
            (self.pools, self.last_tok, self.pos, self.remaining,
             self.active, tok0) = fn(
                self.params, self.pools, self.block_tab, self.last_tok,
                self.pos, self.remaining, self.active,
                torch.from_numpy(seg).to(dev),
                torch.full((1,), base, dtype=torch.int32, device=dev),
                torch.full((1,), last_in_chunk, dtype=torch.int32,
                           device=dev),
                a.slot, final, a.plen, a.req.max_new, a.cache_offset)
        except Exception as e:
            raise BatcherFault(e) from e
        if tel:
            # stamped once the host holds the chunk's token (the
            # reference stamps right after its asynchronous dispatch):
            # on the card the span then covers the chunk's device work.
            tok0 = int(tok0)
            tel.note_chunk(a.req.rid, a.slot, c, t0, tel.clock(),
                           base=base, final=final)
        self.prefill_chunks += 1
        a.next_chunk += 1
        if not final:
            return
        self._admitting.popleft()
        tok0 = int(tok0)
        # drafter history = every token the model has consumed (prompt +
        # first sampled token); invariant len == pos + 1.
        self._history[a.slot] = [int(t) for t in a.req.prompt] + [tok0]
        self._reset_drafter(a.slot)
        if a.resume is not None:
            # the first token reached the consumer before the preemption:
            # arm the suppressed-output replay instead.
            replay = a.resume.pos - a.plen
            self._slot_req[a.slot] = a.req
            self._host_pos[a.slot] = a.plen
            self._host_last_tok[a.slot] = tok0
            self._host_remaining[a.slot] = a.resume.remaining + replay
            self._replay_skip[a.slot] = replay + a.resume.skip
            self.resumes += 1
            self.recompute_resumes += 1
            if tel:
                tel.note_resume(a.req.rid, a.slot, "recompute")
            return
        a.req.out.Push(tok0)
        if tel:
            tel.note_first_token(a.req.rid, a.slot, tel.clock(), pos=a.plen)
        if a.req.max_new > 1 and a.plen < self.max_seq - 1:
            self._slot_req[a.slot] = a.req
            self._host_pos[a.slot] = a.plen
            self._host_last_tok[a.slot] = tok0
            self._host_remaining[a.slot] = a.req.max_new - 1
        else:                                  # retired at admission
            a.req.out.close()
            self.retired += 1
            self._release_slot(a.slot, prompt=a.req.prompt)
            if tel:
                tel.note_retire(a.req.rid, a.slot)

    def _release_slot(self, slot: int, prompt: Optional[np.ndarray] = None,
                      keep_shared: bool = False) -> None:
        """Release the slot's pages (every group) and invalidate its block
        table rows so later (masked) decode writes never touch reused
        pages.

        With the prefix cache and a retiring ``prompt``, the prompt's full
        token blocks are first inserted into the ``PrefixIndex``: pages
        backing newly indexed blocks transfer the slot's reference to the
        index (the prefix lingers as cache), everything else is
        decref'd.  ``keep_shared`` (preemption): the leading shared
        pages keep their references, which the parked record owns."""
        absorbed: frozenset = frozenset()
        if self._prefix is not None and prompt is not None and len(prompt):
            pages = {name: self._slot_pages[name][slot]
                     for name in self._slot_pages}
            absorbed = frozenset(self._prefix.insert(
                np.asarray(prompt, np.int32), pages))
        for name in self._slot_pages:
            ns = self._slot_nshared[name][slot] if keep_shared else 0
            rest = [p for i, p in enumerate(self._slot_pages[name][slot])
                    if i >= ns and i not in absorbed]
            if rest:
                self._alloc[name].free(rest)
            self._slot_pages[name][slot] = []
            self._slot_nshared[name][slot] = 0
            self.block_tab[name][slot] = self.n_pages[name]
        self._history[slot] = []

    # -- lazy decode growth + preemption ------------------------------------------------

    def _pick_victim(self) -> Optional[int]:
        """Lowest-ranked decoding slot: SLA class first (batch parks
        before standard before latency), then the priority knob, ties
        toward the most recently admitted."""
        cands = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not cands:
            return None
        return min(cands, key=lambda i: (class_rank(self._slot_req[i].klass),
                                         self._slot_req[i].priority,
                                         -self._slot_seq[i]))

    def _preempt(self, slot: int) -> None:
        """Spill the slot's PRIVATE pages to the host, free them, park the
        request.  Pages still shared with the prefix cache are not
        spilled (immutable while shared): the record keeps the slot's
        references and resume re-attaches the same physical pages.  The
        spill is ONE staged transfer for all groups, leaf dtypes kept.

        Tiered recompute policy: a sequence with fewer than
        ``tier_restore_min`` positions is cheaper to re-prefill than to
        stage through host RAM, so nothing is spilled; its prompt blocks
        retire into the prefix index and resume re-admits and replays.
        A spill that fails (rung 2) parks a recompute record too."""
        r = self._slot_req[slot]
        pos = self._host_pos[slot]
        recompute = self._tiers is not None and pos < self.tier_restore_min
        if not recompute:
            counts: Dict[str, int] = {}
            shared: Dict[str, List[int]] = {}
            priv: Dict[str, List[int]] = {}
            for g in self.layout.groups:
                pages = self._slot_pages[g.name][slot]
                ns = self._slot_nshared[g.name][slot]
                shared[g.name] = pages[:ns]
                priv[g.name] = pages[ns:]
                counts[g.name] = len(pages) - ns
            tel = self._telemetry
            t0 = tel.clock() if tel else 0.0
            ok, gathered = self._tier_op(
                "spill", lambda: self._xfer.gather_host(self.pools, priv))
            if ok:
                data = {name: gathered.get(name) for name in priv}
                self._preempted.append(_Preempted(
                    req=r, pos=pos, last_tok=self._host_last_tok[slot],
                    remaining=self._host_remaining[slot], data=data,
                    counts=counts, seq=self._slot_seq[slot], shared=shared,
                    skip=self._replay_skip[slot],
                    hist=list(self._history[slot])))
                self._replay_skip[slot] = 0
                self.active[slot] = False
                self._slot_req[slot] = None
                self._release_slot(slot, keep_shared=True)
                self.preemptions += 1
                self.preempted_rids.append(r.rid)
                if tel:
                    tel.note_spill(r.rid, t0, tel.clock())
                    tel.note_preempt(r.rid, slot, pos, "spill")
                return
        self._preempted.append(_Preempted(
            req=r, pos=pos, last_tok=self._host_last_tok[slot],
            remaining=self._host_remaining[slot], data={}, counts={},
            seq=self._slot_seq[slot], mode="recompute",
            skip=self._replay_skip[slot]))
        self._replay_skip[slot] = 0
        self.active[slot] = False
        self._slot_req[slot] = None
        self._release_slot(slot, prompt=r.prompt)
        self.preemptions += 1
        self.preempted_rids.append(r.rid)
        if self._telemetry:
            self._telemetry.note_preempt(r.rid, slot, pos, "recompute")

    def _grow_slot(self, slot: int) -> bool:
        """Ensure every group holds a WRITABLE page for the slot's next
        decode write; preempts other slots when the pool is dry
        (self-preempts as a last resort).  Returns False iff the slot was
        preempted.  A write landing inside a page still shared with the
        prefix cache copies it first (copy-on-write): the page is
        duplicated into a fresh private page and the table redirected, so
        the cached original stays bit-stable for every sequence aliasing
        it."""
        nxt = self._host_pos[slot]             # position decode writes next

        def take_one(name: str) -> Optional[List[int]]:
            got = self._alloc_evict(name, 1)
            while got is None:
                victim = self._pick_victim()
                if victim is None or victim == slot:
                    self._preempt(slot)
                    return None
                self._preempt(victim)
                got = self._alloc_evict(name, 1)
            return got

        for g in self.layout.groups:
            need = self.layout.blocks_for(g.name, nxt + 1, self.max_seq)
            pages = self._slot_pages[g.name][slot]
            while len(pages) < need:
                got = take_one(g.name)
                if got is None:
                    return False
                pages.append(got[0])
                self.block_tab[g.name][slot, len(pages) - 1] = got[0]
            j = need - 1                       # page holding the write
            if j < self._slot_nshared[g.name][slot]:
                got = take_one(g.name)
                if got is None:
                    return False
                self.layout.copy_pages(self.pools, g.name, [pages[j]], got)
                self._alloc[g.name].free([pages[j]])   # drop the shared ref
                pages[j] = got[0]
                self.block_tab[g.name][slot, j] = got[0]
                self._slot_nshared[g.name][slot] = j
                self.cow_copies += 1
        self._note_peak()
        return True

    def _try_resume(self) -> int:
        """Restore preempted requests into free slots, highest rank (then
        oldest) first; all page groups alloc-or-nothing.  Restore mode
        re-attaches the shared prefix pages (the record kept the slot's
        references) and scatters every group's spilled payload into
        fresh pages in one staged transfer; recompute mode re-admits the
        prompt and replays.  A failed restore converts the record to
        recompute (rung 2)."""
        resumed = 0
        while self._preempted:
            busy = {a.slot for a in self._admitting}
            free = [i for i, r in enumerate(self._slot_req)
                    if r is None and i not in busy]
            if not free:
                break
            idx = min(range(len(self._preempted)),
                      key=lambda i: (-class_rank(self._preempted[i].req.klass),
                                     -self._preempted[i].req.priority,
                                     self._preempted[i].seq))
            rec = self._preempted[idx]
            slot = free[0]
            if self._expiry_left_ms(rec.req) <= 0:
                # expired while parked: drop its shared refs and end the
                # consumer; no slot spent on a dead SLA.
                self._preempted.pop(idx)
                for name, pgs in rec.shared.items():
                    if pgs:
                        self._alloc[name].free(pgs)
                self._fail_request(rec.req, TerminalEvent.expired(
                    rec.req.rid, "deadline passed while preempted"))
                self.retired += 1
                continue
            if rec.mode == "recompute":
                self._preempted.pop(idx)
                if self._try_admit_paged(rec.req, slot, resume=rec):
                    resumed += 1
                    continue
                self._preempted.insert(idx, rec)   # pool dry: park again
                break
            grabbed: Dict[str, List[int]] = {}
            for g in self.layout.groups:
                # headroom: also cover the next decode write, so a resumed
                # slot emits at least one token before it can be preempted
                # again (no spill/restore thrash on a still-dry pool).
                ns = len(rec.shared.get(g.name, ()))
                need = max(rec.counts[g.name],
                           self.layout.blocks_for(g.name, rec.pos + 1,
                                                  self.max_seq) - ns)
                pages = self._alloc_evict(g.name, need)
                if pages is None:
                    break
                grabbed[g.name] = pages
            if len(grabbed) < len(self.layout.groups):
                for name, pgs in grabbed.items():
                    self._alloc[name].free(pgs)
                break
            self._preempted.pop(idx)
            tel = self._telemetry
            t0 = tel.clock() if tel else 0.0
            ok, pools = self._tier_op(
                "restore", lambda: self._xfer.scatter_device(
                    self.pools,
                    {name: rec.data[name] for name in grabbed
                     if rec.counts[name]},
                    {name: grabbed[name][:rec.counts[name]]
                     for name in grabbed if rec.counts[name]}))
            if not ok:
                # drop the payload and convert to a recompute record: the
                # replay regenerates the same KV from tokens.  Our refs
                # on shared prefix pages go back; the re-admission's
                # match re-attaches them.
                for name, pgs in grabbed.items():
                    self._alloc[name].free(pgs)
                for name, pgs in rec.shared.items():
                    if pgs:
                        self._alloc[name].free(pgs)
                rec.mode = "recompute"
                rec.data, rec.counts, rec.shared = {}, {}, {}
                self._preempted.insert(idx, rec)
                continue
            self.pools = pools
            for name, priv in grabbed.items():
                pages = rec.shared.get(name, []) + priv
                self._set_table_row(name, slot, pages)
                self._slot_pages[name][slot] = list(pages)
                self._slot_nshared[name][slot] = len(rec.shared.get(name, ()))
            self._note_peak()
            self.last_tok[slot] = rec.last_tok
            self.pos[slot] = rec.pos
            self.remaining[slot] = rec.remaining
            self.active[slot] = True
            self._slot_req[slot] = rec.req
            self._slot_seq[slot] = rec.seq
            self._host_pos[slot] = rec.pos
            self._host_last_tok[slot] = rec.last_tok
            self._host_remaining[slot] = rec.remaining
            self._replay_skip[slot] = rec.skip
            self._history[slot] = list(rec.hist)
            self._reset_drafter(slot)
            self.resumes += 1
            resumed += 1
            if tel:
                tel.note_restore(rec.req.rid, t0, tel.clock())
                tel.note_resume(rec.req.rid, slot, "restore")
        return resumed

    # -- fatal faults: shutdown vs crash recovery --------------------------------------

    def fail_inflight(self, cause: BaseException) -> int:
        """Terminate every request the batcher still owes an outcome —
        active slots, mid-admission, parked, queued — with typed events
        (Errored for work in flight, Cancelled for work never admitted)
        so no consumer waits out a drain timeout.  Touches no device
        state and enters no collective: on a sharded serve it drains this
        rank's own queue and stream, since a rank that fails on its own
        has peers that will not join one.  Returns the number of
        requests terminated."""
        n = 0
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._fail_request(r, TerminalEvent.errored(r.rid, cause))
                self._slot_req[i] = None
                self.retired += 1
                n += 1
        while self._admitting:
            a = self._admitting.popleft()
            self._fail_request(a.req, TerminalEvent.errored(a.req.rid, cause))
            self.retired += 1
            n += 1
        while self._preempted:
            rec = self._preempted.pop()
            self._fail_request(rec.req,
                               TerminalEvent.errored(rec.req.rid, cause))
            self.retired += 1
            n += 1
        while True:
            r = self._pending.popleft() if self._pending \
                else self.requests.TryPop()
            if r is None:
                break
            self._fail_request(r, TerminalEvent.cancelled(
                r.rid, "batcher shut down before admission"))
            self.retired += 1
            n += 1
        return n

    def _rebuild_paged_state(self) -> None:
        """Fresh device pools, allocators, block tables and slot state
        after a fatal step fault.  The host tier survives (its payloads
        are host copies taken before the fault); the prefix index is
        rebuilt empty (its pages died with the pools)."""
        n_slots, dev, i32 = self.n_slots, self.device, torch.int32
        self._alloc = {name: PageAllocator(n)
                       for name, n in self.n_pages.items()}
        self._slot_pages = {name: [[] for _ in range(n_slots)]
                            for name in self.n_pages}
        self._slot_nshared = {name: [0] * n_slots for name in self.n_pages}
        if self._prefix is not None:
            self._prefix = PrefixIndex([g.name for g in self.layout.groups],
                                       self.page_size, self.prefix_block)
        self.pools = self._new_pools()
        self.block_tab = {
            name: torch.full((n_slots, self.n_blocks[name]),
                             self.n_pages[name], dtype=i32, device=dev)
            for name in self.n_pages}
        self.last_tok = torch.zeros((n_slots,), dtype=i32, device=dev)
        self.pos = torch.zeros((n_slots,), dtype=i32, device=dev)
        self.remaining = torch.zeros((n_slots,), dtype=i32, device=dev)
        self.active = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
        self._host_pos = [0] * n_slots
        self._host_last_tok = [0] * n_slots
        self._host_remaining = [0] * n_slots
        self._slot_seq = [0] * n_slots
        self._replay_skip = [0] * n_slots
        self._history = [[] for _ in range(n_slots)]
        self._accept_ewma = [1.0] * n_slots
        self._probe_at = [0] * n_slots
        self._probe_gap = [0] * n_slots
        self._ng_idx = [{} for _ in range(n_slots)]
        self._ng_done = [0] * n_slots
        self._admitting.clear()
        self._preempted = []

    def recover(self) -> int:
        """Crash recovery after a fatal step fault (``ServeSupervisor``
        calls this between run() attempts): journal every in-flight
        request as a recompute-mode record, rebuild the device pools and
        resubmit the journal.  Greedy decode is deterministic and the
        replay suppresses already-emitted tokens, so every surviving
        stream is bit-identical to a fault-free run.  Returns the number
        of requests resubmitted."""
        if not self.paged:
            raise RuntimeError("recover() requires the paged batcher; "
                               "the dense path has no journaled replay")
        journal: List[_Preempted] = []
        for slot, r in enumerate(self._slot_req):
            if r is None:
                continue
            journal.append(_Preempted(
                req=r, pos=self._host_pos[slot],
                last_tok=self._host_last_tok[slot],
                remaining=self._host_remaining[slot],
                data={}, counts={}, seq=self._slot_seq[slot],
                mode="recompute", skip=self._replay_skip[slot]))
            self._slot_req[slot] = None
        # mid-admission: a resume re-journals its (recompute) record; a
        # fresh admission emitted nothing yet and re-queues, in order.
        fresh: List[Request] = []
        while self._admitting:
            a = self._admitting.popleft()
            if a.resume is not None:
                journal.append(a.resume)
            else:
                fresh.append(a.req)
        # parked records' shared pages referenced the dead pools: every
        # record becomes recompute (deterministic replay is exact).
        for rec in self._preempted:
            rec.mode = "recompute"
            rec.data, rec.counts, rec.shared = {}, {}, {}
            journal.append(rec)
        self._rebuild_paged_state()
        self._preempted = journal
        self._pending.extendleft(reversed(fresh))
        self.restarts += 1
        self._stalled = False
        if self._telemetry:
            # the pre-fault events' rid: a replayed request's trace
            # stitches to its original across the restart.
            for rec in journal:
                self._telemetry.note_recover_journal(
                    rec.req.rid, rec.pos, "recompute", self.restarts)
            for r in fresh:
                self._telemetry.event(r.rid, "recover_requeue",
                                      restart=self.restarts)
        return len(journal) + len(fresh)

    # -- T2 snapshots -------------------------------------------------------------------

    def save_tier_snapshot(self, path: Optional[str] = None
                           ) -> Optional[str]:
        """Persist the host tier to disk (T2), the live device index
        flushed through ``demote`` first, so a new batcher constructed
        with the same ``tier_snapshot`` serves its first system-prompt
        hit with only the catch-up chunk.  Returns the path written, or
        None when the tier is off."""
        if self._tiers is None:
            return None
        p = path or self.tier_snapshot
        if not p:
            raise ValueError("no snapshot path: pass one or set "
                             "cfg.kv_tier_snapshot / tier_snapshot=")
        lead = self._lock is None or self._lock.leader
        self._tiers.save(p, index=self._prefix, pools=self.pools,
                         write=lead)
        if self._lock is not None:           # the file is whole for all
            import torch.distributed as dist
            dist.barrier()
        return p

    # -- producer / scheduler ------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Validate + enqueue; returns True iff the request entered the
        queue.  Degenerate requests are rejected here, in the producer's
        thread: a prompt that leaves no room to decode, ``max_new <= 1``,
        or, for the recurrent families, a prompt shorter than the conv
        window's K - 1 inputs (its prefill would raise inside ``run()``
        and end the batcher with the requests queued beside it).  The
        ``ValueError`` is paired with a typed rejection pushed into
        ``req.out`` so its consumer ends.

        At a full queue, ``overload="block"`` backpressures the producer
        and ``"reject"`` sheds with a typed ``queue_full`` rejection and
        returns False (a shed request does not count toward
        ``retired``).  On a sharded serve the shed is rank 0's
        (``Lockstep.try_push``): every rank sheds the same requests."""
        reason = None
        conv = self.cfg.ssm_conv - 1
        if len(req.prompt) >= self.max_seq - 1:
            reason = (f"prompt length {len(req.prompt)} >= max_seq - 1 "
                      f"({self.max_seq - 1}); no decode budget left")
        elif (self.cfg.family in ("ssm", "hybrid")
              and len(req.prompt) < conv):
            reason = (f"prompt length {len(req.prompt)} < the conv "
                      f"window's K - 1 = {conv} inputs the recurrent "
                      "decode cache holds")
        elif req.max_new <= 1:
            reason = (f"max_new={req.max_new} <= 1 would retire at "
                      f"admission; request at least 2 tokens")
        if reason is not None:
            self._fail_request(req, TerminalEvent.rejected(
                req.rid, f"invalid: {reason}"))
            raise ValueError(f"request {req.rid}: {reason}")
        req.submitted_at = self._clock()
        if self._telemetry:
            self._telemetry.note_submit(req)
        if req.deadline_ms is not None:
            self._deadlines_live = True
        if self.overload == "reject":
            pushed = (self._lock.try_push(self.requests, req)
                      if self._lock is not None
                      else self.requests.TryPush(req))
            if not pushed:
                self._fail_request(req, TerminalEvent.rejected(
                    req.rid, "queue_full"))
                return False
        else:
            self.requests.Push(req)
        return True

    def _schedule_pending(self) -> None:
        """SLA mode: drain every queued arrival into ``_pending`` and keep
        it ordered by (class rank desc, deadline asc, submit order), so a
        latency-class arrival overtakes queued batch work; equal-SLA
        requests still serve FIFO."""
        while True:
            r = self._try_pop()
            if r is None:
                break
            if r.submitted_at == 0.0:
                r.submitted_at = self._now()
                if self._telemetry:
                    self._telemetry.note_submit(r)
            if r.deadline_ms is not None:
                self._deadlines_live = True
            self._pending.append(r)
        if len(self._pending) > 1:
            self._pending = collections.deque(sorted(
                self._pending,
                key=lambda r: (-class_rank(r.klass),
                               r.deadline_ms if r.deadline_ms is not None
                               else float("inf"),
                               r.submitted_at, r.rid)))

    def _backlog_tokens(self) -> int:
        """Tokens of work owed ahead of a new admission (active decode
        budgets + admitting prefill remainders + parked work)."""
        t = sum(self._host_remaining[i]
                for i, r in enumerate(self._slot_req) if r is not None)
        t += sum((a.n_chunks - a.next_chunk) * self.chunk + a.req.max_new
                 for a in self._admitting)
        t += sum(rec.remaining for rec in self._preempted)
        return t

    def _note_rate(self, dt: float, toks: int) -> None:
        """Fold one decode/verify step (wall time and tokens retired)
        into the smoothed throughput model."""
        self._ewma_step_s = (dt if self._ewma_step_s == 0.0
                             else 0.8 * self._ewma_step_s + 0.2 * dt)
        self._ewma_step_tok = (float(toks) if self._ewma_step_tok == 0.0
                               else 0.8 * self._ewma_step_tok + 0.2 * toks)

    def _projected_delay_ms(self) -> float:
        """Projected queueing delay of a new admission: backlog tokens at
        the smoothed measured throughput (tokens retired per step)."""
        return (self._ewma_step_s * 1e3
                * self._backlog_tokens() / max(self._ewma_step_tok, 1.0))

    def admit(self) -> int:
        """Fill free slots.  Dense: pop the request stream and run one
        batched padded prefill per bucket.  Paged: resume preempted
        requests first, then pop the request stream; each placed request
        reserves its prompt pages (or waits at the FIFO head — admission
        backpressure) and enters chunked prefill.

        Lifecycle gates run before any slot or page is spent: a request
        whose deadline passed in the queue expires, and (paged, SLA)
        batch-class work whose deadline budget is below the projected
        queue delay is shed with a typed ``deadline_unmeetable``."""
        if self.schedule == "sla":
            self._schedule_pending()
        if not self.paged:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            pairs = []
            while len(pairs) < len(free):
                r = self._next_request()
                if r is None:
                    break
                if self._expiry_left_ms(r) <= 0:
                    self._fail_request(r, TerminalEvent.expired(
                        r.rid, "deadline passed in queue"))
                    self.retired += 1
                    continue
                pairs.append((free[len(pairs)], r))
            if pairs:
                self._admit_batch(pairs)
            return len(pairs)
        admitted = self._try_resume()
        busy = {a.slot for a in self._admitting}
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in busy]
        fi = 0
        while fi < len(free):
            r = self._next_request()
            if r is None:
                break
            left = self._expiry_left_ms(r)
            if left <= 0:
                self._fail_request(r, TerminalEvent.expired(
                    r.rid, "deadline passed in queue"))
                self.retired += 1
                continue
            if (self.schedule == "sla" and r.klass == "batch"
                    and left < self._projected_delay_ms()):
                self._fail_request(r, TerminalEvent.rejected(
                    r.rid, "deadline_unmeetable"))
                self.retired += 1
                continue
            if len(r.prompt) >= self.max_seq or r.max_new < 1:
                self._reject(r)    # bypassed submit() validation
                continue
            if any(self._full_pages_needed(r, g.name) > self.n_pages[g.name]
                   for g in self.layout.groups):
                self._reject(r)    # can never fit, even in an empty pool
                continue
            if not self._try_admit_paged(r, free[fi]):
                self._pending.appendleft(r)    # pool dry: wait for a retire
                break
            fi += 1
            admitted += 1
        return admitted

    def _cancel_expired_slots(self) -> int:
        """Cancel in-flight requests whose deadline passed: typed Expired
        event (with the tokens already streamed), pages freed at once."""
        n = 0
        for i, r in enumerate(self._slot_req):
            if r is None or self._expiry_left_ms(r) > 0:
                continue
            self._fail_request(r, TerminalEvent.expired(
                r.rid, "deadline passed mid-decode"))
            self.active[i] = False
            self._slot_req[i] = None
            if self.paged:
                self._release_slot(i)
                self._replay_skip[i] = 0
            self.retired += 1
            n += 1
        return n

    # -- speculative decode (draft / verify / commit-or-rollback) ----------------------

    def _reset_drafter(self, slot: int) -> None:
        """Fresh acceptance state for a slot whose history was replaced."""
        self._accept_ewma[slot] = 1.0
        self._probe_at[slot] = 0
        self._probe_gap[slot] = 0
        self._ng_idx[slot].clear()
        self._ng_done[slot] = 0

    def _draft(self, slot: int) -> List[int]:
        """Self-speculative n-gram draft for one slot: the tokens that
        followed the most recent earlier occurrence of the history's
        trailing ``speculate_ngram``-gram, ``min(speculate_k, remaining -
        1)`` of them (a shorter continuation is not proposed: the verify
        span costs the same whatever the draft).  A slot whose acceptance
        EWMA fell below ``speculate_min_accept`` drafts only as a probe:
        on the global grid of ``speculate_probe`` steps, at or after its
        backed-off ``_probe_at``; a probe that finds no match backs off
        as a failed round does."""
        probing = self._accept_ewma[slot] < self.speculate_min_accept
        if probing and not (
                self.speculate_probe
                and self.steps >= self._probe_at[slot]
                and self.steps % self.speculate_probe == 0):
            return []
        cap = min(self.speculate_k, self._host_remaining[slot] - 1)
        if cap <= 0:
            return []
        hist = self._history[slot]
        n = len(hist)
        ng = self.speculate_ngram
        if n > ng:
            # extend the position index over the tokens appended since
            # the last call, then look the trailing ngram up.
            idx = self._ng_idx[slot]
            done = self._ng_done[slot]
            if done > n - ng:
                idx.clear()
                done = 0
            for j in range(done, n - ng):
                idx.setdefault(tuple(hist[j:j + ng]), []).append(j)
            self._ng_done[slot] = max(done, n - ng)
            posns = idx.get(tuple(hist[n - ng:]))
            if posns:
                # the most recent occurrence whose continuation fills the
                # whole span (j + ng + cap <= n).
                i = bisect.bisect_right(posns, n - ng - cap) - 1
                if i >= 0:
                    j = posns[i]
                    return hist[j + ng:j + ng + cap]
        if probing:
            # the probe found nothing to draft: consume it and back off.
            self._probe_gap[slot] = max(2 * self._probe_gap[slot],
                                        self.speculate_probe // 2, 1)
            self._probe_at[slot] = self.steps + self._probe_gap[slot]
        return []

    def _collect_drafts(self) -> Dict[int, List[int]]:
        """Drafts for every decoding slot; an empty dict sends the step
        down the plain decode path.  The verify span writes
        ``speculate_k + 1`` positions per active slot (padding included),
        so the whole batch must satisfy ``pos + speculate_k <= max_seq -
        2``: a slot that close to the end forces a plain step."""
        lim = self.max_seq - 2 - self.speculate_k
        drafts: Dict[int, List[int]] = {}
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            if self._host_pos[i] > lim:
                return {}
            d = self._draft(i)
            if d:
                drafts[i] = d
        return drafts

    def _spec_setup(self, drafts: Dict[int, List[int]]):
        """Plan the scratch redirection of every drafting slot's verify
        span, on the host: for each logical page ``pos // page .. (pos +
        k) // page`` the span writes, a freshly allocated private scratch
        page (the old page's contents copied in), so speculative writes
        never touch a shared page or a CoW boundary.  A ring group's
        logical page l lives at table entry ``l % n_blocks``.  The copies
        and the
        table swap run inside the verify step from the padded arrays
        built here; the batcher's own table is never touched.  A slot
        whose scratch allocation fails drops its draft (speculation never
        preempts); ``drafts`` is pruned in place.

        Returns ``(swaps, xfer)``: per slot its ``_Swap`` records, and the
        per-group padded arrays ``(copy_src, copy_dst, swap_rows,
        swap_cols, swap_vals)`` of fixed length ``n_slots * (k // page +
        2)``; copy padding points dst at ``n_pages``, swap padding rows at
        ``n_slots``."""
        k_span = self.speculate_k + 1
        swaps: Dict[int, List[_Swap]] = {}
        for slot in list(drafts):
            pos = self._host_pos[slot]
            recs: List[_Swap] = []
            ok = True
            for g in self.layout.groups:
                name = g.name
                nb = self.n_blocks[name]
                pages = self._slot_pages[name][slot]
                for l in range(pos // self.page_size,
                               (pos + k_span - 1) // self.page_size + 1):
                    j = l % nb if g.ring else l
                    if j >= nb:          # flat span past the table: the
                        continue         # pos gate forbids it
                    got = self._alloc_evict(name, 1)
                    if got is None:
                        ok = False
                        break
                    old = pages[j] if j < len(pages) else None
                    recs.append((name, l, j, old, got[0]))
                if not ok:
                    break
            if not ok:       # dry pool: free grabbed scratch, drop draft
                for name, _, _, _, scr in recs:
                    self._alloc[name].free([scr])
                del drafts[slot]
                continue
            swaps[slot] = recs
        cap = self.n_slots * ((k_span - 1) // self.page_size + 2)
        copy_src, copy_dst, rows, cols, vals = {}, {}, {}, {}, {}
        fill = {}
        for g in self.layout.groups:
            copy_src[g.name] = np.zeros(cap, np.int32)
            copy_dst[g.name] = np.full(cap, self.n_pages[g.name], np.int32)
            rows[g.name] = np.full(cap, self.n_slots, np.int32)
            cols[g.name] = np.zeros(cap, np.int32)
            vals[g.name] = np.zeros(cap, np.int32)
            fill[g.name] = 0
        for slot, recs in swaps.items():
            for name, _, j, old, scr in recs:
                i = fill[name]
                fill[name] = i + 1
                rows[name][i] = slot
                cols[name][i] = j
                vals[name][i] = scr
                if old is not None:
                    copy_src[name][i] = old
                    copy_dst[name][i] = scr
        self._note_peak()
        return swaps, (copy_src, copy_dst, rows, cols, vals)

    def _spec_unwind(self, swaps) -> None:
        """Abort path: free every scratch page so the allocator stays
        consistent.  The batcher's table was never touched (the swap
        lives inside the failed call), so nothing else is restored."""
        for recs in swaps.values():
            for name, _, _, _, scr in recs:
                self._alloc[name].free([scr])

    def _spec_resolve(self, swaps, commit: np.ndarray) -> None:
        """Commit or roll back by block-table swap.  Pages holding
        committed positions (logical <= page of ``pos + commit - 1``)
        take their scratch page into the slot's page list and the table
        (the old page, if any, is freed); the others free the scratch.
        A committed page may hold rejected rows past the commit point:
        they are causally masked on every read until decode overwrites
        them."""
        updates: Dict[str, List[Tuple[int, int, int]]] = {}
        for slot, recs in swaps.items():
            c = int(commit[slot])
            last_page = (self._host_pos[slot] + c - 1) // self.page_size
            for name, l, j, old, scr in recs:
                pages = self._slot_pages[name][slot]
                if c > 0 and l <= last_page:           # commit
                    if j < len(pages):
                        if old is not None:
                            self._alloc[name].free([old])
                        pages[j] = scr
                    else:
                        assert j == len(pages)
                        pages.append(scr)
                    updates.setdefault(name, []).append((slot, j, scr))
                else:                                  # roll back
                    self._alloc[name].free([scr])
        self._scatter_tab(updates)

    def _scatter_tab(self, updates: Dict[str, List[Tuple[int, int, int]]]
                     ) -> None:
        """One batched block-table entry scatter per group."""
        for name, items in updates.items():
            idx = torch.as_tensor(np.asarray(items, np.int64),
                                  device=self.device)
            self.block_tab[name][idx[:, 0], idx[:, 1]] = \
                idx[:, 2].to(torch.int32)

    def _spec_step(self, drafts: Dict[int, List[int]], swaps, xfer) -> int:
        """One batched draft-verify-commit step covering ALL active
        slots: drafting slots feed [last_tok, d_1..d_n, pad...], the rest
        [last_tok, pad...] (n_draft = 0 commits exactly 1, plain decode).
        The bookkeeping mirrors ``step()`` but advances every host mirror
        by the slot's commit count."""
        k = self.speculate_k + 1
        n = self.n_slots
        tokens = np.zeros((n, k), np.int32)
        n_draft = np.zeros((n,), np.int32)
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            tokens[i, 0] = self._host_last_tok[i]
            d = drafts.get(i, ())
            tokens[i, 1:1 + len(d)] = d
            tokens[i, 1 + len(d):] = tokens[i, len(d)]   # pad (masked)
            n_draft[i] = len(d)
        dev = self.device
        tel = self._telemetry
        tr = self._tracer
        if tr is not None:
            sp = tr.open("serve.verify")
            t0 = sp.t0
        else:
            t0 = tel.clock() if tel else time.monotonic()
        try:
            # an injected verify fault fires AFTER scratch setup: the
            # unwind below must leave the allocator consistent.
            self._fault.check("verify")
            (self.pools, self.last_tok, self.pos, self.remaining,
             self.active, out) = self._verify(
                self.params, self.pools, self.block_tab,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(n_draft).to(dev),
                self.pos, self.remaining, self.active, *xfer)
            t1 = sp.close() if tr is not None else (
                tel.clock() if tel else time.monotonic())
        except Exception as e:
            self._spec_unwind(swaps)
            raise BatcherFault(e) from e
        if tr is not None:
            wait = tr.open("serve.decode.wait", at=t1)
            out = out.cpu().numpy()
            t_round = wait.close()
            emit = tr.open("serve.decode.emit", at=t_round)
        else:
            out = out.cpu().numpy()            # the ONLY per-step transfer
            t_round = tel.clock() if tel else 0.0
        if tel:
            # stamped after the host read (the reference stamps before
            # it): the round then ends when its tokens reach the host.
            tel.note_verify_round(t0, t_round,
                                  n_drafting=int((n_draft > 0).sum()))
        preds, commit, finished = out[:k], out[k], out[k + 1]
        self._spec_resolve(swaps, commit)
        done = 0
        committed = 0
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            c = int(commit[i])
            for t in range(c):
                tok = int(preds[t, i])
                if self._replay_skip[i] > 0:
                    self._replay_skip[i] -= 1
                else:
                    r.out.Push(tok)
                    if tel:
                        # a round's committed tokens arrive together.
                        tel.note_token(r.rid, i, t_round,
                                       pos=self._host_pos[i] + t)
                self._history[i].append(tok)
            self._host_last_tok[i] = int(preds[c - 1, i])
            self._host_pos[i] += c
            self._host_remaining[i] -= c
            committed += c
            nd = int(n_draft[i])
            if nd:
                if tel:
                    tel.note_spec(r.rid, i, nd, c - 1)
                self._note_acceptance(i, nd, c - 1)
            if finished[i]:
                r.out.close()
                self._slot_req[i] = None
                self._release_slot(i, prompt=r.prompt)
                done += 1
                if tel:
                    tel.note_retire(r.rid, i)
        self.spec_verify_steps += 1
        self.steps += 1
        self.retired += done
        self._note_rate(t1 - t0, committed)
        if tr is not None:
            emit.close()
        return done

    def _note_acceptance(self, i: int, nd: int, acc: int) -> None:
        """Count a drafting slot's round and update its acceptance EWMA
        and probe schedule."""
        self.spec_drafted += nd
        self.spec_accepted += acc
        self.spec_rolled_back += nd - acc
        floor = self.speculate_min_accept
        if self._accept_ewma[i] < floor:
            # probe round: re-enable only on decisively good acceptance
            # (2x the floor: hysteresis), back off while probes fail.
            good = acc >= min(1.0, 2.0 * floor) * nd
            self._accept_ewma[i] = acc / nd if good else 0.0
            if not good:
                self._probe_gap[i] *= 2
                self._probe_at[i] = self.steps + self._probe_gap[i]
            return
        if acc == 0:
            # a fully rejected span is maximal evidence: cut hard.
            self._accept_ewma[i] *= 0.25
        else:
            self._accept_ewma[i] = (0.5 * self._accept_ewma[i]
                                    + 0.5 * (acc / nd))
        if self._accept_ewma[i] < floor:
            # just disabled: the first probe on the next grid tick.
            self._probe_gap[i] = max(self.speculate_probe // 2, 1)
            self._probe_at[i] = self.steps + self._probe_gap[i]

    def step(self) -> int:
        """One batched decode step; returns the number of sequences
        retired.  Paged: every decoding slot's block table first grows to
        cover its next write position (preempting if the pool is dry);
        with ``speculate_k`` a step whose slots drafted runs as one
        verify step instead.  A failure inside (or injected before) the
        step call is fatal and surfaces as ``BatcherFault``; under a
        ``ServeSupervisor`` the batcher journals, rebuilds and replays
        (``recover``).  Under ``reserve_decode`` every page was reserved
        at admission, so no table grows.  When tracing, the call is the
        ``serve.decode_step`` span."""
        tr = self._tracer
        if tr is None:
            return self._decode_step(None)
        with tr.open("serve.decode_step", owner=self.steps,
                     number=self.steps) as sp:
            return self._decode_step(sp)

    def _decode_step(self, sp) -> int:
        """``step``'s body; ``sp`` its span, None when not tracing."""
        if self._deadlines_live:
            self._cancel_expired_slots()
        tr = self._tracer
        if self.paged and not self.reserve_decode:
            grow = tr.open("serve.grow") if tr is not None else None
            for slot in range(self.n_slots):
                if self._slot_req[slot] is not None:
                    self._grow_slot(slot)
            if grow is not None:
                grow.close()
        if all(r is None for r in self._slot_req):
            return 0
        if self.speculate_k:
            drafts = self._collect_drafts()
            if drafts:
                swaps, xfer = self._spec_setup(drafts)
                if drafts:       # setup may prune drafts (dry pool)
                    return self._spec_step(drafts, swaps, xfer)
        n_live = sum(1 for r in self._slot_req if r is not None)
        tel = self._telemetry
        # one pair of stamps around the launches feeds the span, the
        # step histogram's start and the rate model.
        if tr is not None:
            sp.args = {"n_live": n_live}
            launch = tr.open("serve.decode.launch")
            t0 = launch.t0
        else:
            t0 = tel.clock() if tel else time.monotonic()
        try:
            self._fault.check("step")
            if self.paged:
                (self.pools, self.last_tok, self.pos, self.remaining,
                 self.active, out) = self._step(
                    self.params, self.pools, self.block_tab,
                    self.last_tok, self.pos, self.remaining, self.active)
            else:
                (self.cache, self.last_tok, self.pos, self.remaining,
                 self.active, out) = self._step(
                    self.params, self.cache, self.last_tok, self.pos,
                    self.remaining, self.active)
            t1 = launch.close() if tr is not None else (
                tel.clock() if tel else time.monotonic())
        except Exception as e:
            raise BatcherFault(e) from e
        self._note_rate(t1 - t0, n_live)
        if tr is not None:
            wait = tr.open("serve.decode.wait", at=t1)
            out = out.cpu().numpy()
            t_step = wait.close()
            emit = tr.open("serve.decode.emit", at=t_step)
        else:
            out = out.cpu().numpy()            # the ONLY per-step transfer
            t_step = tel.clock() if tel else 0.0
        if tel:
            # stamped once the host holds the tokens, where the consumer
            # sees them.  The reference stamps right after its
            # asynchronous dispatch, before the read; on the card that
            # would time the launches only and leave the device's tail
            # out of the step histogram and every token stamp.
            tel.note_decode_step(t0, t_step, n_live)
        toks, finished = out[0], out[1]
        done = 0
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            if self._replay_skip[i] > 0:
                # recompute-mode replay: this token reached the consumer
                # before the preemption; the step only rebuilds its KV.
                self._replay_skip[i] -= 1
            else:
                r.out.Push(int(toks[i]))
                if tel:
                    tel.note_token(
                        r.rid, i, t_step,
                        pos=self._host_pos[i] if self.paged else -1)
            self._host_last_tok[i] = int(toks[i])
            self._host_pos[i] += 1
            self._host_remaining[i] -= 1
            if self.speculate_k:
                self._history[i].append(int(toks[i]))
            if finished[i]:
                r.out.close()
                self._slot_req[i] = None
                if self.paged:
                    # retire: the prompt's full pages are offered to the
                    # prefix cache (decref instead of free).
                    self._release_slot(i, prompt=r.prompt)
                done += 1
                if tel:
                    tel.note_retire(r.rid, i)
        self.steps += 1
        self.retired += done
        if tr is not None:
            emit.close()
        return done

    def run(self, total_requests: int, *, poll_timeout: float = 1.0) -> None:
        """Batcher PE: admit + decode until ``total_requests`` retire.

        ``prefill_interleave`` decode steps run between consecutive prompt
        chunks, so a long admission never freezes in-flight slots.  When
        everything is idle the batcher blocks on the request stream with a
        timeout and re-checks; a closed stream ends the loop.  Preempted
        requests count as pending work.  Each iteration beats the
        supervisor's heartbeat and turns a watchdog stall into a
        ``BatcherFault``.

        A fault escaping the loop is fatal: unsupervised, every in-flight
        request is errored (typed events, no consumer hangs) before it
        propagates; under a ``ServeSupervisor`` a ``BatcherFault``
        propagates as-is and the supervisor drives ``recover`` or
        ``fail_inflight``.  When tracing, each iteration after the
        heartbeat is the ``serve.iteration`` span."""
        self._decodes_since_chunk = 0
        tr = self._tracer
        try:
            while self.retired < total_requests:
                if self._heartbeat is not None:
                    self._heartbeat.beat("batcher")
                if tr is None:
                    closed = self._iterate(poll_timeout)
                else:
                    with tr.open("serve.iteration"):
                        closed = self._iterate(poll_timeout)
                if closed:
                    return
        except BatcherFault as e:
            if not self._supervised:
                self.fail_inflight(e.cause)
            raise
        except BaseException as e:
            if not self._supervised:
                self.fail_inflight(e)
            raise

    def _iterate(self, poll_timeout: float) -> bool:
        """One iteration of ``run``'s loop: admit, then one prefill
        chunk or one decode step, or wait for a request.  Returns True
        when the request stream is closed."""
        if self._tick():
            raise BatcherFault(StallFault(
                "batcher run loop missed its heartbeat window"))
        tr = self._tracer
        if tr is None:
            self.admit()
        else:
            with tr.open("serve.admit"):
                self.admit()
        busy = any(r is not None for r in self._slot_req)
        if self._admitting:
            if busy and self._decodes_since_chunk < self.prefill_interleave:
                self.step()
                self._decodes_since_chunk += 1
            else:
                self._prefill_step()
                self._decodes_since_chunk = 0
            return False
        if busy:
            self.step()
            return False
        if self._pending or self._preempted:
            return False       # waiting on pages; admit() retries
        try:
            r = (self._follow(self._lock.pop, poll_timeout)
                 if self._lock is not None
                 else self.requests.Pop(timeout=poll_timeout))
        except TimeoutError:
            return False
        except StreamClosed:
            return True
        if r is None:
            return False
        self._pending.appendleft(r)
        return False


def drain(req: Request, timeout: float = 30.0) -> List[int]:
    """Consumer helper: collect a request's full output stream.  A typed
    ``TerminalEvent`` in the stream re-raises as the matching
    ``RequestFailed`` subclass, carrying the tokens received and chaining
    the original cause; a timeout means the batcher stalled without
    managing to say so."""
    out: List[int] = []
    while True:
        try:
            v = req.out.Pop(timeout=timeout)
        except StreamClosed:
            return out
        except TimeoutError:
            raise TimeoutError(
                f"drain(rid={req.rid}) timed out after {timeout:.0f}s with "
                f"{len(out)} token(s) received — batcher stalled or died")
        if isinstance(v, TerminalEvent):
            raise v.to_error(out) from v.cause
        out.append(v)
