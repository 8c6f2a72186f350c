"""Continuous batching over dense slots or paged KV (port of
``serve/batching.py``).

Requests arrive on a bounded ``Stream``; the batcher packs them into
fixed slots, decodes all active slots together with one batched step,
and retires finished sequences into per-request output streams,
immediately reusing the slot.  The per-slot decode state (last token,
position, remaining budget, active mask) lives in device tensors; the
only per-step device-to-host transfer is the (2, n_slots) int32 array of
next tokens and finished flags.

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
— once pages free up.  A request whose prompt cannot get pages waits at
the head of the FIFO; one that could not fit even an empty pool is
rejected.

This slice runs both modes with FIFO admission and the blocking
overload policy, bf16 or int8 KV.  The prefix cache, host tiers,
speculative decode, SLA scheduling, fault injection, telemetry and mesh
sharding come with later slices; the constructor raises if asked for
them.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.stream import Stream, StreamClosed
from ..models import params as PP
from ..models import registry
from ..models.cache_layouts import get_layout
from .prefix_cache import PageAllocator
from .serve_loop import (advance_slots, make_chunk_prefill_step,
                         make_paged_decode_step)

_MIN_BUCKET = 8            # smallest prefill bucket (pad-to-power-of-two)
_MIN_CHUNK = 16            # smallest auto-selected prefill chunk

# constructor keywords of the reference that belong to later slices.
_LATER_KWARGS = {
    "prefix_cache": "prefix-cache", "prefix_block": "prefix-cache",
    "prefill_exact": "prefix-cache", "host_tier_bytes": "tiered-memory",
    "tier_snapshot": "tiered-memory", "tier_restore_min": "tiered-memory",
    "schedule": "resilience", "overload": "resilience",
    "queue_depth": "resilience", "faults": "resilience",
    "clock": "resilience", "telemetry": "telemetry",
    "reserve_decode": "serving-benchmarks",
}


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
    is replaced when the slot is next admitted."""

    def step_fn(params, cache, last_tok, pos, remaining, active):
        logits, cache = registry.forward(
            cfg, params, {"tokens": last_tok[:, None].long()}, mode="decode",
            cache=cache, pos=pos)
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
    scatter).  Returns the updated state and ``tok0`` (n_rows,) int32."""

    def admit_fn(params, cache, last_tok, pos, remaining, active, prompts,
                 lens, rows, slots, max_new):
        logits, cache1 = registry.forward(
            cfg, params, {"tokens": prompts.long()}, mode="prefill",
            cache_len=max_seq, last_pos=lens - 1)
        tok0 = torch.argmax(logits[:, -1], -1).to(torch.int32)
        _scatter_rows(cache, cache1, rows, slots)
        lens, max_new = lens[rows], max_new[rows]
        last_tok[slots] = tok0[rows]
        pos[slots] = lens
        remaining[slots] = max_new - 1
        active[slots] = (max_new > 1) & (lens < max_seq - 1)
        return cache, last_tok, pos, remaining, active, tok0

    return admit_fn


def _scatter_rows(cache, cache1, rows, slots) -> None:
    """Write prefill rows ``rows`` of every leaf of ``cache1`` into slots
    ``slots`` of the same leaf of ``cache``, in place.  Every leaf of a
    dense slot cache (attention K/V, recurrent conv/ssd state, nested
    for hybrid) has its slot axis at 1."""
    for name, c in cache.items():
        if isinstance(c, dict):
            _scatter_rows(c, cache1[name], rows, slots)
        else:
            c[:, slots] = cache1[name][:, rows]


class RequestFailed(RuntimeError):
    """A request that ended without its tokens: rejected at admission or
    failed in flight.  ``drain`` raises it with the tokens streamed."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"request {rid}: {reason}")
        self.rid, self.reason = rid, reason
        self.tokens: List[int] = []


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int
    priority: int = 0            # higher = preempted later
    out: Stream = dataclasses.field(
        default_factory=lambda: Stream(depth=4096, name="resp"))


@dataclasses.dataclass
class _Admission:
    """A request mid-chunked-prefill: owns a slot + pages, not decoding."""
    req: Request
    slot: int
    plen: int
    next_chunk: int
    n_chunks: int


@dataclasses.dataclass
class _Preempted:
    """A preempted decode: its KV pages parked on the host, slot released.
    ``pos``/``last_tok``/``remaining`` mirror the slot's device state at
    preemption; ``data``/``counts`` hold the spilled pages per group."""
    req: Request
    pos: int
    last_tok: int
    remaining: int
    data: Dict[str, Any]
    counts: Dict[str, int]
    seq: int                     # admission order (preemption tie-break)


class ContinuousBatcher:
    """Fixed-slot continuous batcher over dense slots or paged KV, with
    device-resident slot state.  ``paged`` says which mode runs: paged
    when a page size is given (or the config's ``kv_page_size``) and the
    family has a pageable layout, dense slots otherwise.  ``device`` is
    where the caches and slot state live; the parameters must already be
    there."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_seq: int, n_pages=None,
                 page_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_interleave: Optional[int] = None,
                 device="cuda", **later):
        for k, v in later.items():
            if k not in _LATER_KWARGS:
                raise TypeError(f"unexpected keyword argument {k!r}")
            if v is not None:
                raise NotImplementedError(
                    f"{k}= comes with the {_LATER_KWARGS[k]} slice")
        psz = int(page_size or cfg.kv_page_size)
        for on, what in ((cfg.prefix_cache or cfg.prefill_exact,
                          "the prefix cache"),
                         (cfg.kv_host_tier_bytes or cfg.kv_tier_snapshot,
                          "tiered KV memory"),
                         (cfg.kv_reserve_decode, "reserve-at-admission"),
                         (cfg.speculate_k, "speculative decode"),
                         (cfg.serve_schedule != "fifo"
                          or cfg.serve_overload != "block" or cfg.fault_plan,
                          "SLA scheduling, shedding and fault injection"),
                         (cfg.mesh_shape, "mesh-sharded serving")):
            if on:
                raise NotImplementedError(
                    f"{what} comes with a later port slice")
        self.layout = get_layout(cfg, psz) if psz else None
        self.paged = self.layout is not None
        self.cfg, self.params = cfg, params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.requests: Stream = Stream(
            depth=cfg.serve_queue_depth or 2 * n_slots, name="requests")
        self.rejections: Dict[str, int] = {}
        self.steps = 0
        self.retired = 0
        self.prefill_chunks = 0
        self.preemptions = 0
        self.resumes = 0
        self.peak_pages = 0
        self.preempted_rids: List[int] = []

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

        if not self.paged:
            self.cache = PP.init_params(
                registry.cache_decls(cfg, n_slots, max_seq),
                device=self.device)
            self._step = _make_step_fn(cfg, max_seq)
            self._admit_fn = _make_admit_fn(cfg, max_seq)
            return
        self.page_size = psz
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
            self.n_pages = {g.name: int(n_pages) for g in self.layout.groups}
        self.chunk = int(prefill_chunk or cfg.prefill_chunk
                         or max(self.page_size, _MIN_CHUNK))
        self.prefill_interleave = int(
            cfg.prefill_interleave if prefill_interleave is None
            else prefill_interleave)
        self._alloc = {name: PageAllocator(n)
                       for name, n in self.n_pages.items()}
        self._slot_pages: Dict[str, List[List[int]]] = {
            name: [[] for _ in range(n_slots)] for name in self.n_pages}
        self.pools = PP.init_params(
            registry.paged_cache_decls(cfg, self.n_pages, self.page_size),
            device=self.device)
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

    # -- shared helpers -------------------------------------------------------------

    def _next_request(self) -> Optional[Request]:
        if self._pending:
            return self._pending.popleft()
        return self.requests.TryPop()

    def _fail_request(self, r: Request, reason: str) -> None:
        """End a request with an in-band ``RequestFailed`` + close, so its
        consumer's ``drain`` raises instead of waiting out a timeout."""
        try:
            r.out.Push(RequestFailed(r.rid, reason), timeout=1.0)
        except (TimeoutError, StreamClosed):
            pass
        r.out.close()

    def _reject(self, r: Request, reason: str = "unservable") -> None:
        self._fail_request(r, f"rejected: {reason}")
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        self.retired += 1

    def total_used_pages(self) -> int:
        return sum(a.used_pages for a in self._alloc.values())

    def stats(self) -> Dict[str, Any]:
        """Scheduling counters; paged mode adds per-group pool occupancy."""
        s: Dict[str, Any] = {
            "paged": self.paged,
            "steps": self.steps, "retired": self.retired,
            "preemptions": self.preemptions, "resumes": self.resumes,
            "prefill_chunks": self.prefill_chunks,
            "peak_pages": self.peak_pages,
            "rejections": dict(self.rejections),
        }
        if self.paged:
            s["pools"] = {name: {"free": a.free_pages, "used": a.used_pages}
                          for name, a in self._alloc.items()}
        return s

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
            for row, (slot, r) in enumerate(grp):
                r.out.Push(int(tok0[row]))
                if r.max_new > 1 and len(r.prompt) < self.max_seq - 1:
                    self._slot_req[slot] = r
                else:                          # retired at admission
                    r.out.close()
                    self.retired += 1

    # -- paged admission (chunked prefill) --------------------------------------------

    def _full_pages_needed(self, r: Request, group: str) -> int:
        """Worst-case pages the request can ever hold in this group."""
        total = min(len(r.prompt) + r.max_new, self.max_seq)
        return self.layout.blocks_for(group, total, self.max_seq)

    def _set_table_row(self, group: str, slot: int, pages: List[int]) -> None:
        row = np.full((self.n_blocks[group],), self.n_pages[group], np.int32)
        row[:len(pages)] = pages
        self.block_tab[group][slot] = torch.from_numpy(row).to(self.device)

    def _note_peak(self) -> None:
        self.peak_pages = max(self.peak_pages, self.total_used_pages())

    def _try_admit_paged(self, r: Request, slot: int) -> bool:
        """Reserve the prompt's pages + a slot and start chunked prefill.
        Returns False (leaving ``r`` to the caller) when any group's pool
        is dry — all-or-nothing across page groups."""
        plen = len(r.prompt)
        grabbed: Dict[str, List[int]] = {}
        for g in self.layout.groups:
            pages = self._alloc[g.name].alloc(
                self.layout.blocks_for(g.name, plen, self.max_seq))
            if pages is None:
                for name, pgs in grabbed.items():
                    self._alloc[name].free(pgs)
                return False
            grabbed[g.name] = pages
        for name, pages in grabbed.items():
            self._set_table_row(name, slot, pages)
            self._slot_pages[name][slot] = list(pages)
        self._note_peak()
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        self._admitting.append(_Admission(
            req=r, slot=slot, plen=plen, next_chunk=0,
            n_chunks=max(1, _ceil_div(plen, self.chunk))))
        return True

    def _prefill_step(self) -> None:
        """Run ONE chunk of the oldest mid-admission request."""
        a = self._admitting[0]
        C, c = self.chunk, a.next_chunk
        final = c == a.n_chunks - 1
        base = c * C
        seg = np.zeros((1, C), np.int32)
        part = np.asarray(a.req.prompt[base:base + C], np.int32)
        seg[0, :len(part)] = part
        last_in_chunk = (a.plen - 1 - base) if final else (C - 1)
        dev = self.device
        (self.pools, self.last_tok, self.pos, self.remaining, self.active,
         tok0) = self._chunk_fn(
            self.params, self.pools, self.block_tab, self.last_tok,
            self.pos, self.remaining, self.active,
            torch.from_numpy(seg).to(dev),
            torch.full((1,), base, dtype=torch.int32, device=dev),
            torch.full((1,), last_in_chunk, dtype=torch.int32, device=dev),
            a.slot, final, a.plen, a.req.max_new, 0)
        self.prefill_chunks += 1
        a.next_chunk += 1
        if not final:
            return
        self._admitting.popleft()
        tok0 = int(tok0)
        a.req.out.Push(tok0)
        if a.req.max_new > 1 and a.plen < self.max_seq - 1:
            self._slot_req[a.slot] = a.req
            self._host_pos[a.slot] = a.plen
            self._host_last_tok[a.slot] = tok0
            self._host_remaining[a.slot] = a.req.max_new - 1
        else:                                  # retired at admission
            a.req.out.close()
            self.retired += 1
            self._release_slot(a.slot)

    def _release_slot(self, slot: int) -> None:
        """Free the slot's pages (every group) and invalidate its block
        table rows so later (masked) decode writes never touch reused
        pages."""
        for name in self._slot_pages:
            if self._slot_pages[name][slot]:
                self._alloc[name].free(self._slot_pages[name][slot])
            self._slot_pages[name][slot] = []
            self.block_tab[name][slot] = self.n_pages[name]

    # -- lazy decode growth + preemption ------------------------------------------------

    def _pick_victim(self) -> Optional[int]:
        """Lowest-priority decoding slot, ties toward the most recently
        admitted."""
        cands = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not cands:
            return None
        return min(cands, key=lambda i: (self._slot_req[i].priority,
                                         -self._slot_seq[i]))

    def _preempt(self, slot: int) -> None:
        """Spill the slot's pages to the host, free them, park the
        request."""
        r = self._slot_req[slot]
        data, counts = {}, {}
        for g in self.layout.groups:
            pages = self._slot_pages[g.name][slot]
            data[g.name] = self.layout.spill(self.pools, g.name, pages)
            counts[g.name] = len(pages)
        self._preempted.append(_Preempted(
            req=r, pos=self._host_pos[slot],
            last_tok=self._host_last_tok[slot],
            remaining=self._host_remaining[slot], data=data, counts=counts,
            seq=self._slot_seq[slot]))
        self.active[slot] = False
        self._slot_req[slot] = None
        self._release_slot(slot)
        self.preemptions += 1
        self.preempted_rids.append(r.rid)

    def _grow_slot(self, slot: int) -> bool:
        """Ensure every group holds a page for the slot's next decode
        write; preempts other slots when the pool is dry (self-preempts
        as a last resort).  Returns False iff the slot was preempted."""
        nxt = self._host_pos[slot]             # position decode writes next
        for g in self.layout.groups:
            need = self.layout.blocks_for(g.name, nxt + 1, self.max_seq)
            pages = self._slot_pages[g.name][slot]
            while len(pages) < need:
                got = self._alloc[g.name].alloc(1)
                while got is None:
                    victim = self._pick_victim()
                    if victim is None or victim == slot:
                        self._preempt(slot)
                        return False
                    self._preempt(victim)
                    got = self._alloc[g.name].alloc(1)
                pages.append(got[0])
                self.block_tab[g.name][slot, len(pages) - 1] = got[0]
        self._note_peak()
        return True

    def _try_resume(self) -> int:
        """Restore preempted requests into free slots, highest priority
        (then oldest) first; all page groups alloc-or-nothing."""
        resumed = 0
        while self._preempted:
            busy = {a.slot for a in self._admitting}
            free = [i for i, r in enumerate(self._slot_req)
                    if r is None and i not in busy]
            if not free:
                break
            idx = min(range(len(self._preempted)),
                      key=lambda i: (-self._preempted[i].req.priority,
                                     self._preempted[i].seq))
            rec = self._preempted[idx]
            slot = free[0]
            grabbed: Dict[str, List[int]] = {}
            for g in self.layout.groups:
                # headroom: also cover the next decode write, so a resumed
                # slot emits at least one token before it can be preempted
                # again (no spill/restore thrash on a still-dry pool).
                need = max(rec.counts[g.name],
                           self.layout.blocks_for(g.name, rec.pos + 1,
                                                  self.max_seq))
                pages = self._alloc[g.name].alloc(need)
                if pages is None:
                    break
                grabbed[g.name] = pages
            if len(grabbed) < len(self.layout.groups):
                for name, pgs in grabbed.items():
                    self._alloc[name].free(pgs)
                break
            self._preempted.pop(idx)
            for name, pages in grabbed.items():
                n = rec.counts[name]
                if n:
                    self.layout.restore(self.pools, name, rec.data[name],
                                        pages[:n])
                self._set_table_row(name, slot, pages)
                self._slot_pages[name][slot] = list(pages)
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
            self.resumes += 1
            resumed += 1
        return resumed

    # -- producer / scheduler ------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Validate + enqueue (blocking while the queue is full).
        Degenerate requests are rejected here, in the producer's thread:
        a prompt that leaves no room to decode, ``max_new <= 1``, or, for
        the recurrent families, a prompt shorter than the conv window's
        K - 1 inputs (its prefill would raise inside ``run()`` and end
        the batcher with the requests queued beside it).  The rejection
        is also pushed into ``req.out`` so its consumer ends."""
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
            self._fail_request(req, f"invalid: {reason}")
            raise ValueError(f"request {req.rid}: {reason}")
        self.requests.Push(req)
        return True

    def admit(self) -> int:
        """Fill free slots.  Dense: pop the request stream and run one
        batched padded prefill per bucket.  Paged: resume preempted
        requests first, then pop the request stream; each placed request
        reserves its prompt pages (or waits at the FIFO head — admission
        backpressure) and enters chunked prefill."""
        if not self.paged:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            pairs = []
            while len(pairs) < len(free):
                r = self._next_request()
                if r is None:
                    break
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

    def step(self) -> int:
        """One batched decode step; returns the number of sequences
        retired.  Paged: every decoding slot's block table first grows to
        cover its next write position (preempting if the pool is dry)."""
        if self.paged:
            for slot in range(self.n_slots):
                if self._slot_req[slot] is not None:
                    self._grow_slot(slot)
        if all(r is None for r in self._slot_req):
            return 0
        if self.paged:
            (self.pools, self.last_tok, self.pos, self.remaining,
             self.active, out) = self._step(
                self.params, self.pools, self.block_tab, self.last_tok,
                self.pos, self.remaining, self.active)
        else:
            (self.cache, self.last_tok, self.pos, self.remaining,
             self.active, out) = self._step(
                self.params, self.cache, self.last_tok, self.pos,
                self.remaining, self.active)
        out = out.cpu().numpy()                # the ONLY per-step transfer
        toks, finished = out[0], out[1]
        done = 0
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            r.out.Push(int(toks[i]))
            self._host_last_tok[i] = int(toks[i])
            self._host_pos[i] += 1
            self._host_remaining[i] -= 1
            if finished[i]:
                r.out.close()
                self._slot_req[i] = None
                if self.paged:
                    self._release_slot(i)
                done += 1
        self.steps += 1
        self.retired += done
        return done

    def _fail_inflight(self, cause: BaseException) -> None:
        """End every request the batcher still owes an outcome, so no
        consumer waits out a drain timeout after a fatal error."""
        owed = [r for r in self._slot_req if r is not None]
        owed += [a.req for a in self._admitting]
        owed += [rec.req for rec in self._preempted]
        owed += list(self._pending)
        while True:
            r = self.requests.TryPop()
            if r is None:
                break
            owed.append(r)
        for r in owed:
            self._fail_request(r, f"failed: {type(cause).__name__}: {cause}")

    def run(self, total_requests: int, *, poll_timeout: float = 1.0) -> None:
        """Batcher PE: admit + decode until ``total_requests`` retire.

        ``prefill_interleave`` decode steps run between consecutive prompt
        chunks, so a long admission never freezes in-flight slots.  When
        everything is idle the batcher blocks on the request stream with a
        timeout and re-checks; a closed stream ends the loop.  Preempted
        requests count as pending work."""
        decodes_since_chunk = 0
        try:
            while self.retired < total_requests:
                self.admit()
                busy = any(r is not None for r in self._slot_req)
                if self._admitting:
                    if busy and decodes_since_chunk < self.prefill_interleave:
                        self.step()
                        decodes_since_chunk += 1
                    else:
                        self._prefill_step()
                        decodes_since_chunk = 0
                    continue
                if busy:
                    self.step()
                    continue
                if self._pending or self._preempted:
                    continue       # waiting on pages; admit() retries
                try:
                    r = self.requests.Pop(timeout=poll_timeout)
                except TimeoutError:
                    continue
                except StreamClosed:
                    return
                self._pending.appendleft(r)
        except BaseException as e:
            self._fail_inflight(e)
            raise


def drain(req: Request, timeout: float = 30.0) -> List[int]:
    """Consumer helper: collect a request's full output stream.  A
    ``RequestFailed`` in the stream is raised with the tokens received."""
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
        if isinstance(v, RequestFailed):
            v.tokens = out
            raise v
        out.append(v)
