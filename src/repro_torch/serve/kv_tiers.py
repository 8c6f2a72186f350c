"""Tiered KV memory (port of ``serve/kv_tiers.py``): device pools (T0), a
host-RAM prefix/spill store (T1), and on-disk snapshots (T2).

This module owns ALL page movement between tiers: preemption
spill/resume, prefix demote to T1 and T1 promote back to the device.

* ``StagedTransferEngine`` — batched device<->host page transfers.  On
  the card a spill dispatches one ``index_select`` per pool leaf on the
  current stream and records an event after each; a copy stream waits
  on that event and copies the leaf into a pinned host buffer
  (``non_blocking``), so the copy of leaf *k* overlaps the gather of
  leaf *k + 1* (the reference's double buffer).  The engine waits for
  the copy stream's last event before it hands the payload back, so no
  caller reads or pickles a pinned buffer that is still being written.
  A restore stages every payload onto the device on the copy stream
  (pinning a pageable source first), the current stream waits on the
  copies' event, and one ``index_copy_`` per leaf scatters the pages in
  stream order behind every decode write already queued.  On the CPU
  (the tests) the same calls run in program order.  Leaf dtypes are
  preserved end to end: int8 pages spill as int8 with their bf16 scale
  pages, and ``restore_pages`` raises on a dtype mismatch.

* ``HostPageStore`` (T1) — a bounded host-RAM page store.  Entries are
  content-addressed by the SHA-1 of the FULL token path of a prefix
  block (``_content_key``, byte-identical to the reference's keys), each
  holding host tensors of the ``pages_per_block`` pages of every group.
  It LRU-evicts under its own byte budget; entries are host tensors
  only, so its eviction can never strand a refcounted device page.

* ``KVTierManager`` — demote on prefix eviction, match / restore_chain
  on admission, and T2 ``save`` / ``load`` with a sha256 envelope.

The port's T2 snapshots are its own format: the payload pickles torch
CPU tensors and the leaf signature names torch dtypes
(``torch.bfloat16``).  The port never imports ``ml_dtypes``, so it does
not read a snapshot the JAX package wrote: ``load`` unpickles through an
allow-list of torch and builtin globals, and such a file fails with
``SnapshotCorruptError`` (it names numpy / ml_dtypes globals) or
``ValueError`` (a signature that names other dtypes) — never loads
garbage.

Sharded serving keeps each rank's own tile on the host: the engine
copies a rank's tiles of the pages to pinned memory and back, with no
collective per transfer, so a tp-way serve pins the host tier's budget
once in all (each rank a tp-th of it), as the reference's one
controller does.  The store still counts every entry at full width
(``CacheLayout.page_nbytes``, passed by ``demote``), so its LRU,
evictions and the restore-or-recompute policy decide the same on every
rank and on one process.  Only a T2 snapshot is full width: ``save``
gathers the tiles over the model group (every rank joins; ``save``'s
``write`` caller writes the file) and ``load`` cuts each payload to the
rank's tile (``CacheLayout.full_tile`` / ``local_tile``), so a snapshot
one mesh wrote restores on another and on one process.

The recompute-vs-restore policy (``tier_restore_min_tokens``) lives in
the batcher.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..distributed.sharding import manual_axis
from ..models.params import Decl, tree_leaves, tree_map
from .resilience import FaultPlan

# v2 wraps the payload in a {version, sha256, blob} envelope so load can
# verify content integrity before unpickling the payload proper.
_SNAPSHOT_VERSION = 2


class SnapshotCorruptError(RuntimeError):
    """A T2 snapshot failed integrity verification (truncated file,
    checksum mismatch, unreadable pickle).  Callers treat this as a
    logged cold start — unlike a geometry mismatch (``ValueError``),
    which means the snapshot is *valid but wrong for this layout* and
    keeps raising."""


class _SnapshotUnpickler(pickle.Unpickler):
    """Unpickles only what the port writes: builtins, ``OrderedDict``
    and torch's tensor rebuild functions.  Anything else (a numpy or
    ml_dtypes array of a JAX-package snapshot) is refused, so foreign
    files never import modules or load as pages."""

    def find_class(self, module, name):
        if (module == "torch" or module.startswith("torch.")
                or (module, name) == ("collections", "OrderedDict")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not part of a port snapshot")


def _unpickle(data: bytes):
    return _SnapshotUnpickler(io.BytesIO(data)).load()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_nbytes(tree) -> int:
    return sum(_nbytes(leaf) for leaf in tree_leaves(tree))


def _flip_bit(path: str) -> None:
    """Simulated bit-rot: flip one bit in the middle of the file (inside
    the checksummed blob, so load's digest check must catch it)."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        mid = f.tell() // 2
        f.seek(mid)
        b = f.read(1)
        f.seek(mid)
        f.write(bytes([b[0] ^ 0x40]))


def _truncate_half(path: str) -> None:
    """Simulated torn write / partial copy: drop the file's second half."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _content_key(tokens) -> bytes:
    """Content address of a prefix: SHA-1 digest of its canonical int64
    token bytes (the reference's keys, byte for byte).  ``KVTierManager.
    match`` computes the per-block digests incrementally, so a whole
    chain walk is O(L)."""
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes()).digest()


class StagedTransferEngine:
    """Batched, double-buffered device<->host page movement.

    One engine per batcher serves every transfer consumer — preemption
    spill/resume, prefix demote to T1, T1 promote back to device — so
    the transfer counters in ``stats()`` describe all tier traffic.
    ``clock`` is the batcher's injectable time base; every staged call
    is timed with it into ``gather_seconds`` / ``scatter_seconds`` and,
    when a ``ServeTelemetry`` is attached, observed into the
    ``serve_transfer_{gather,scatter}_seconds`` histograms.  ``group``
    is the model axis's process group of a sharded batcher: payloads
    are this rank's tiles, and ``d2h_bytes`` / ``h2d_bytes`` count the
    bytes this rank copies (a tp-th of the full width).  ``KVTierManager``
    gathers them over ``group`` only to write a snapshot.
    """

    def __init__(self, layout, faults: Optional[FaultPlan] = None,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry=None, group=None):
        self.layout = layout
        self.group = group
        self.faults = faults or FaultPlan()
        self._clock = clock or time.monotonic
        self._telemetry = telemetry
        self.gathers = 0             # staged spill/demote calls
        self.scatters = 0            # staged restore/promote calls
        self.d2h_bytes = 0
        self.h2d_bytes = 0
        self.gather_s = 0.0          # cumulative wall time (clock units)
        self.scatter_s = 0.0
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # the last restore's host sources and the event after their H2D
        # copies: held until the next restore, so no pinned source is
        # released while its copy may still be reading it.
        self._h2d_hold: Optional[tuple] = None

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=device)
        return self._copy_stream

    def gather_host(self, pools, pages_by_group: Dict[str, Sequence[int]]
                    ) -> Dict[str, Any]:
        """Spill the given pages of every group to host tensors (groups
        with no pages are omitted).  On the card: one ``index_select``
        per pool leaf on the current stream, each followed by an event
        the copy stream waits on before it copies that leaf into a
        pinned buffer; the host waits once, for the last copy.  Leaves are
        this rank's tiles, as the pools hold them."""
        if not any(pages_by_group.values()):
            return {}                   # nothing to move: not a transfer
        self.faults.check("t1_d2h")
        return self._gather_host(pools, pages_by_group)

    def _gather_host(self, pools, pages_by_group):
        t0 = self._clock()
        out: Dict[str, Any] = {}
        done = None
        for name, pages in pages_by_group.items():
            if not pages:
                continue
            ax = self.layout.page_axis(name)
            leaves = pools[name]
            dev = next(iter(tree_leaves(leaves))).device
            idx = torch.as_tensor(list(pages), dtype=torch.int64, device=dev)
            if dev.type != "cuda":
                out[name] = tree_map(lambda _, a: a.index_select(ax, idx),
                                     leaves)
                continue
            cur = torch.cuda.current_stream(dev)
            side = self._stream(dev)

            def stage(_, a):
                g = a.index_select(ax, idx)
                ev = torch.cuda.Event()
                ev.record(cur)
                host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                side.wait_event(ev)
                with torch.cuda.stream(side):
                    host.copy_(g, non_blocking=True)
                g.record_stream(side)
                return host

            out[name] = tree_map(stage, leaves)
            done = torch.cuda.Event()
            done.record(side)
        if done is not None:
            done.synchronize()          # payload complete before any read
        dt = self._clock() - t0
        self.gathers += 1
        self.d2h_bytes += sum(_tree_nbytes(t) for t in out.values())
        self.gather_s += dt
        if self._telemetry:
            self._telemetry.h_gather.observe(dt)
        return out

    def scatter_device(self, pools, data_by_group: Dict[str, Any],
                       pages_by_group: Dict[str, Sequence[int]]):
        """Restore host payloads into the given physical pages.  On the
        card every payload leaf is staged onto the device on the copy
        stream (async H2D from pinned memory), the current stream waits
        on the copies' event, then one ``index_copy_`` per pool leaf runs
        in stream order.  Payloads are this rank's tiles (``gather_host``'s,
        or a snapshot's cut by ``KVTierManager.load``).  Returns the pools
        dict (updated in place)."""
        if not any(pages_by_group.get(name) for name in data_by_group):
            return pools                # nothing to move: not a transfer
        self.faults.check("t1_h2d")
        return self._scatter_device(pools, data_by_group, pages_by_group)

    def _scatter_device(self, pools, data_by_group, pages_by_group):
        t0 = self._clock()
        names = [n for n in data_by_group if pages_by_group.get(n)]
        dev = next(iter(tree_leaves(pools[names[0]]))).device
        staged: Dict[str, Any] = {}
        if dev.type == "cuda":
            if self._h2d_hold is not None:
                self._h2d_hold[0].synchronize()
                self._h2d_hold = None
            cur = torch.cuda.current_stream(dev)
            side = self._stream(dev)
            ready = torch.cuda.Event()
            ready.record(cur)       # staging buffers come from `cur`'s pool
            side.wait_event(ready)
            sources: List[torch.Tensor] = []

            def stage(_, h):
                h = h if h.is_pinned() else h.pin_memory()
                sources.append(h)
                d = torch.empty(h.shape, dtype=h.dtype, device=dev)
                with torch.cuda.stream(side):
                    d.copy_(h, non_blocking=True)
                return d

            for name in names:
                staged[name] = tree_map(stage, data_by_group[name])
            copied = torch.cuda.Event()
            copied.record(side)
            cur.wait_event(copied)
            self._h2d_hold = (copied, sources)
        else:
            staged = {name: data_by_group[name] for name in names}
        for name in names:
            pools = self.layout.restore_pages(pools, name, staged[name],
                                              pages_by_group[name])
            self.h2d_bytes += _tree_nbytes(data_by_group[name])
        dt = self._clock() - t0
        self.scatters += 1
        self.scatter_s += dt
        if self._telemetry:
            self._telemetry.h_scatter.observe(dt)
        return pools

    def stats(self) -> Dict[str, Any]:
        return {"gathers": self.gathers,
                "scatters": self.scatters,
                "d2h_bytes": self.d2h_bytes,
                "h2d_bytes": self.h2d_bytes,
                "gather_seconds": self.gather_s,
                "scatter_seconds": self.scatter_s,
                "staged_gathers": self.gathers,
                "staged_scatters": self.scatters}


class _T1Entry:
    __slots__ = ("data", "nbytes", "stamp")

    def __init__(self, data: Dict[str, Any], nbytes: int, stamp: int):
        self.data = data             # {group: host page payload tree}
        self.nbytes = nbytes
        self.stamp = stamp


class HostPageStore:
    """Bounded host-RAM store of prefix-block page payloads (T1).

    Content-addressed by ``_content_key`` of the block's FULL token path,
    so identical prefixes demoted by different batchers — or reloaded
    from a snapshot — unify.  ``put`` LRU-evicts until the new entry fits
    its byte budget; an entry larger than the whole budget is refused.
    An entry's size is its caller's full-width count, whatever share of
    it this rank holds, so every rank of a mesh evicts alike.
    Entries are host tensors only (no device page ids), so nothing here
    can strand a refcounted device page.
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._store: Dict[Any, _T1Entry] = {}
        self._clock = 0
        self.nbytes = 0
        self.evictions = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._store)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def touch(self, key) -> bool:
        """Refresh the LRU stamp; True iff the key is present (lets a
        demote of an already-cached block skip its device->host copy)."""
        e = self._store.get(key)
        if e is None:
            return False
        e.stamp = self._tick()
        return True

    def get(self, key) -> Optional[Dict[str, Any]]:
        e = self._store.get(key)
        if e is None:
            return None
        e.stamp = self._tick()
        return e.data

    def put(self, key, data: Dict[str, Any],
            nbytes: Optional[int] = None) -> bool:
        """Store ``data`` under ``key`` as an entry of ``nbytes`` (the
        tier's callers pass the full-width count; None: the payload's own
        bytes)."""
        nbytes = int(sum(_tree_nbytes(t) for t in data.values())
                     if nbytes is None else nbytes)
        if nbytes > self.budget:
            self.rejected += 1
            return False
        old = self._store.pop(key, None)
        if old is not None:
            self.nbytes -= old.nbytes
        while self.nbytes + nbytes > self.budget and self._store:
            self._evict_lru()
        self._store[key] = _T1Entry(data, nbytes, self._tick())
        self.nbytes += nbytes
        return True

    def _evict_lru(self) -> None:
        victim = min(self._store, key=lambda k: self._store[k].stamp)
        self.nbytes -= self._store.pop(victim).nbytes
        self.evictions += 1

    def items_lru_order(self):
        """(key, entry) pairs, least recently used first (snapshot
        serialization order: a reload re-``put``s in this order so the
        reconstructed LRU matches)."""
        return sorted(self._store.items(), key=lambda kv: kv[1].stamp)


class KVTierManager:
    """Page movement policy between the device pools and T1/T2.

    Owns the T1 ``HostPageStore`` and uses the batcher's shared
    ``StagedTransferEngine``.  ``block`` is the prefix-index block size —
    T1 entries are exactly one index node's worth of pages per group.
    """

    def __init__(self, layout, page_size: int, block: int,
                 budget_bytes: int, engine: StagedTransferEngine,
                 faults: Optional[FaultPlan] = None):
        self.layout = layout
        self.faults = faults or engine.faults
        self.page = int(page_size)
        self.block = int(block)
        self.bpp = self.block // self.page     # pages per block, per group
        self.store = HostPageStore(budget_bytes)
        self.engine = engine
        self.demotions = 0
        self.demote_skips = 0        # content already in T1 (no copy)
        self.rehits = 0              # promote chains restored
        self.rehit_tokens = 0
        self.recomputes = 0          # policy chose recompute over restore
        self.snapshot_loaded = 0     # entries loaded from T2

    # -- T0 -> T1 (demote on prefix eviction) -------------------------------------

    def demote(self, path_tokens: Sequence[int],
               pages_by_group: Dict[str, Sequence[int]], pools) -> None:
        """Stage an evicted prefix node's pages into T1, with the pages
        still live on the device (the caller frees them after).  A
        content hit skips the copy (indexed page bits are immutable while
        shared); a payload the budget can never hold is refused before
        the gather (full-width sizes, ``CacheLayout.page_nbytes``)."""
        key = _content_key(path_tokens)
        if self.store.touch(key):
            self.demote_skips += 1
            return
        nbytes = sum(self.layout.page_nbytes(name) * len(pages)
                     for name, pages in pages_by_group.items() if pages)
        if nbytes > self.store.budget:
            self.store.rejected += 1
            return
        data = self.engine.gather_host(pools, pages_by_group)
        if self.store.put(key, data, nbytes):
            self.demotions += 1

    # -- T1 -> T0 (promote on rehit) ------------------------------------------------

    def match(self, prompt: np.ndarray, start_block: int
              ) -> List[Dict[str, Any]]:
        """Longest chain of consecutive T1 entries covering blocks
        ``start_block, start_block + 1, ...`` of the prompt, with the
        per-block keys computed by one rolling digest."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int64))
        h = hashlib.sha1(toks[:start_block * self.block].tobytes())
        chain: List[Dict[str, Any]] = []
        b = start_block
        while (b + 1) * self.block <= len(toks):
            h.update(toks[b * self.block:(b + 1) * self.block].tobytes())
            data = self.store.get(h.digest())
            if data is None:
                break
            chain.append(data)
            b += 1
        return chain

    def restore_chain(self, pools, chain: List[Dict[str, Any]],
                      pages_by_group: Dict[str, Sequence[int]]):
        """Scatter a matched chain's payloads into freshly allocated
        pages — one staged transfer for the whole chain (the per-entry
        payloads are concatenated along the page axis on the host)."""
        data: Dict[str, Any] = {}
        for name, pages in pages_by_group.items():
            if not pages:
                continue
            ax = self.layout.page_axis(name)
            parts = [entry[name] for entry in chain]
            data[name] = parts[0] if len(parts) == 1 else tree_map(
                lambda path, _, _ax=ax: _cat([_at(p, path) for p in parts],
                                             _ax), parts[0])
        return self.engine.scatter_device(pools, data, pages_by_group)

    # -- T2 snapshots ----------------------------------------------------------------

    def _payload_signature(self) -> Dict[str, list]:
        """Per-group (shape, torch dtype name) of every pool leaf at one
        block's worth of pages — the exact geometry of a T1 entry
        payload, compared at load so a snapshot of another cache dtype
        or architecture fails at construction."""
        decls = self.layout.pool_decls({g.name: self.bpp
                                        for g in self.layout.groups})
        return {name: sorted((tuple(d.shape), str(d.dtype))
                             for d in tree_leaves(tree)
                             if isinstance(d, Decl))
                for name, tree in decls.items()}

    def save(self, path: str, index=None, pools=None, write: bool = True
             ) -> int:
        """Persist the T1 store to ``path``.  With the live ``index`` (and
        ``pools``) every device-resident cached prefix is flushed through
        ``demote`` first.  The write is atomic (tmp + rename) and the
        payload is wrapped with its SHA-256.  Entries are written at full
        width: on a mesh every rank gathers its tiles over the model group
        (``write=False``, a sharded batcher's ranks but one, does all of it
        but the file, and the snapshot fault sites still count).  Returns
        entries written."""
        if index is not None and pools is not None:
            for path_tokens, pages in index.walk():
                self.demote(path_tokens, pages, pools)
        with manual_axis(self.engine.group):
            entries = [(key, self._full_width(e.data), e.stamp)
                       for key, e in self.store.items_lru_order()]
        if not write:
            self.faults.fire("snapshot_corrupt")
            self.faults.fire("snapshot_truncate")
            return len(entries)
        payload = {
            "page": self.page,
            "block": self.block,
            "groups": sorted(g.name for g in self.layout.groups),
            "leaf_sig": self._payload_signature(),
            "entries": entries,
        }
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        envelope = {
            "version": _SNAPSHOT_VERSION,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "blob": blob,
        }
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(envelope, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        # fault sites for the storage-rot chaos tests: mangle the file
        # AFTER the atomic rename, exactly as bit-rot/truncation would.
        if self.faults.fire("snapshot_corrupt"):
            _flip_bit(path)
        if self.faults.fire("snapshot_truncate"):
            _truncate_half(path)
        return len(entries)

    def load(self, path: str) -> int:
        """Repopulate T1 from a snapshot.  Integrity failures (unreadable
        file, bad envelope, checksum mismatch, truncation, a global that
        is not the port's) raise ``SnapshotCorruptError``; a snapshot
        that verifies but does not fit this layout (page, block, groups,
        leaf shapes and torch dtypes) raises ``ValueError``.  Entries
        re-enter in LRU order under the current byte budget."""
        try:
            with open(path, "rb") as f:
                envelope = _unpickle(f.read())
            if not isinstance(envelope, dict):
                raise SnapshotCorruptError(
                    f"kv tier snapshot {path}: not an envelope")
            version = envelope.get("version")
            blob = envelope.get("blob")
            digest = envelope.get("sha256")
            if (version != _SNAPSHOT_VERSION or not isinstance(blob, bytes)
                    or hashlib.sha256(blob).hexdigest() != digest):
                raise SnapshotCorruptError(
                    f"kv tier snapshot {path}: bad envelope or checksum "
                    f"mismatch (version={version!r})")
            payload = _unpickle(blob)
            if not isinstance(payload, dict) or "entries" not in payload:
                raise SnapshotCorruptError(
                    f"kv tier snapshot {path}: payload malformed")
        except SnapshotCorruptError:
            raise
        except Exception as e:   # OSError, pickle errors, EOF, attribute…
            raise SnapshotCorruptError(
                f"kv tier snapshot {path}: unreadable "
                f"({type(e).__name__}: {e})") from e
        groups = sorted(g.name for g in self.layout.groups)
        if (payload.get("page") != self.page
                or payload.get("block") != self.block
                or payload.get("groups") != groups):
            raise ValueError(
                f"kv tier snapshot {path} geometry mismatch: snapshot "
                f"(page={payload.get('page')}, block={payload.get('block')},"
                f" groups={payload.get('groups')}) vs layout (page="
                f"{self.page}, block={self.block}, groups={groups})")
        sig = self._payload_signature()
        if payload.get("leaf_sig") != sig:
            raise ValueError(
                f"kv tier snapshot {path} geometry mismatch: pool leaf "
                f"shapes/dtypes {payload.get('leaf_sig')} != {sig} — the "
                f"snapshot was taken with a different cache dtype or "
                f"architecture; restoring it would corrupt the pools")
        n = 0
        with manual_axis(self.engine.group):
            for key, data, _stamp in payload["entries"]:
                nbytes = sum(_tree_nbytes(t) for t in data.values())
                if self.store.put(key, self._tile(data), nbytes):
                    n += 1
        self.snapshot_loaded += n
        return n

    def _full_width(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """A T1 payload of this rank's tiles at full width, on the host:
        the tiles gathered over the active model axis (through the card
        when the group is NCCL's, which takes CUDA tensors only); the
        payload itself without a model group."""
        group = self.engine.group
        if group is None:
            return data
        import torch.distributed as dist
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else None)

        def full(name, path, t):
            if dev is None:
                return self.layout.full_tile(name, path, t)
            return self.layout.full_tile(name, path, t.to(dev)).cpu()
        return {name: tree_map(lambda path, t, name=name: full(name, path, t),
                               tree)
                for name, tree in data.items()}

    def _tile(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's tiles of a full-width payload (cut over the active
        model axis, as copies: the full payload is not kept); the payload
        itself without a model group."""
        if self.engine.group is None:
            return data

        def cut(name, path, t):
            tile = self.layout.local_tile(name, path, t)
            return t if tile is t else tile.clone()
        return {name: tree_map(lambda path, t, name=name: cut(name, path, t),
                               tree)
                for name, tree in data.items()}

    # -- observability ----------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "t1_entries": len(self.store),
            "t1_bytes": self.store.nbytes,
            "t1_budget_bytes": self.store.budget,
            "t1_evictions": self.store.evictions,
            "t1_rejected": self.store.rejected,
            "demotions": self.demotions,
            "demote_skips": self.demote_skips,
            "rehits": self.rehits,
            "rehit_tokens": self.rehit_tokens,
            "recomputes": self.recomputes,
            "snapshot_loaded": self.snapshot_loaded,
            **self.engine.stats(),
        }


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _cat(xs: List[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate host payload leaves; pinned parts (T1 entries spilled
    from the card) concatenate into a pinned buffer, so the staged H2D
    copy needs no second host copy to pin them."""
    if not xs[0].is_pinned():
        return torch.cat(xs, dim=dim)
    shape = list(xs[0].shape)
    shape[dim] = sum(x.shape[dim] for x in xs)
    out = torch.empty(shape, dtype=xs[0].dtype, pin_memory=True)
    return torch.cat(xs, dim=dim, out=out)
