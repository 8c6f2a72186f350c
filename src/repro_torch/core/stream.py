"""F4 — hlslib::Stream: bounded, thread-safe FIFO channels.

The paper (§III-A) extends ``hls::stream`` with (a) thread safety so that
multiple concurrently-emulated processing elements can communicate, (b)
bounded-by-default semantics "like the hardware implementation they
represent", and (c) timeout warnings naming the channel and operation so
that deadlocks caused by insufficient FIFO depth can be debugged in
software.

In the PyTorch port a Stream is a literal bounded queue between Python
threads, as in the JAX package's software emulation (``core/stream.py``
there); the serving batcher reads its requests from one.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Deque, Generic, Iterable, List, Optional, TypeVar

T = TypeVar("T")

# Default seconds a Push/Pop may block before emitting a (repeating)
# warning that names the channel — the paper's deadlock-debugging aid.
DEFAULT_WARN_SECONDS = 3.0

# Depth used when none is given.  The paper notes Vivado's default stream
# is a ping-pong buffer, i.e. depth 2.
DEFAULT_DEPTH = 2


class StreamClosed(RuntimeError):
    """Raised when popping from a closed, drained stream."""


@dataclass
class StreamStats:
    pushes: int = 0
    pops: int = 0
    push_waits: int = 0   # number of Push calls that had to block (full)
    pop_waits: int = 0    # number of Pop calls that had to block (empty)
    max_occupancy: int = 0


class Stream(Generic[T]):
    """A bounded, thread-safe FIFO channel.

    Mirrors ``hlslib::Stream``: bounded by default, ``Push``/``Pop`` block
    with periodic warnings naming the stream, and occupancy statistics are
    kept so tests (and users) can verify pipeline behavior — e.g. that a
    depth-1 stream forces lock-step progress of producer/consumer.
    """

    def __init__(self, depth: int = DEFAULT_DEPTH, name: str = "",
                 warn_seconds: float = DEFAULT_WARN_SECONDS):
        if depth < 1:
            raise ValueError(f"Stream depth must be >= 1, got {depth}")
        self.depth = depth
        self.name = name or f"stream@{id(self):x}"
        self.warn_seconds = warn_seconds
        self._q: Deque[T] = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.stats = StreamStats()

    # -- hlslib-style interface ------------------------------------------------

    def Push(self, value: T, timeout: Optional[float] = None) -> None:
        """Blocking push; warns every ``warn_seconds`` while the FIFO is full."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            if len(self._q) >= self.depth:
                self.stats.push_waits += 1
            while len(self._q) >= self.depth:
                if self._closed:
                    raise StreamClosed(f"Push to closed stream '{self.name}'")
                remaining = self.warn_seconds
                if deadline is not None:
                    remaining = min(remaining, deadline - time.monotonic())
                    if remaining <= 0:
                        raise TimeoutError(
                            f"Push to stream '{self.name}' timed out "
                            f"(depth={self.depth} full)")
                if not self._not_full.wait(remaining):
                    if deadline is None or time.monotonic() < deadline:
                        warnings.warn(
                            f"Push to stream '{self.name}' has been blocked "
                            f">{self.warn_seconds:.1f}s (depth={self.depth} "
                            f"full) — possible deadlock", RuntimeWarning,
                            stacklevel=2)
            self._q.append(value)
            self.stats.pushes += 1
            self.stats.max_occupancy = max(self.stats.max_occupancy,
                                           len(self._q))
            self._not_empty.notify()

    def Pop(self, timeout: Optional[float] = None) -> T:
        """Blocking pop; warns every ``warn_seconds`` while the FIFO is empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            if not self._q:
                self.stats.pop_waits += 1
            while not self._q:
                if self._closed:
                    raise StreamClosed(f"Pop from closed stream '{self.name}'")
                remaining = self.warn_seconds
                if deadline is not None:
                    remaining = min(remaining, deadline - time.monotonic())
                    if remaining <= 0:
                        raise TimeoutError(
                            f"Pop from stream '{self.name}' timed out (empty)")
                if not self._not_empty.wait(remaining):
                    if deadline is None or time.monotonic() < deadline:
                        warnings.warn(
                            f"Pop from stream '{self.name}' has been blocked "
                            f">{self.warn_seconds:.1f}s (empty) — possible "
                            f"deadlock", RuntimeWarning, stacklevel=2)
            value = self._q.popleft()
            self.stats.pops += 1
            self._not_full.notify()
            return value

    # -- non-blocking / introspection -------------------------------------------

    def TryPush(self, value: T) -> bool:
        with self._lock:
            if self._closed or len(self._q) >= self.depth:
                return False
            self._q.append(value)
            self.stats.pushes += 1
            self.stats.max_occupancy = max(self.stats.max_occupancy,
                                           len(self._q))
            self._not_empty.notify()
            return True

    def TryPop(self) -> Optional[T]:
        with self._lock:
            if not self._q:
                return None
            value = self._q.popleft()
            self.stats.pops += 1
            self._not_full.notify()
            return value

    def Size(self) -> int:
        with self._lock:
            return len(self._q)

    def Empty(self) -> bool:
        return self.Size() == 0

    def Full(self) -> bool:
        return self.Size() >= self.depth

    def close(self) -> None:
        """Wake all waiters; subsequent blocked Push/Pop raise StreamClosed."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def drain(self) -> List[T]:
        with self._lock:
            out = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
            return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Stream(name={self.name!r}, depth={self.depth}, "
                f"size={self.Size()})")


class UnboundedStream(Stream[T]):
    """What naive sequential C++ emulation implicitly assumes (paper §II-C):
    an unbounded FIFO.  Provided so tests can reproduce the paper's
    software-vs-hardware divergence for cyclic dataflow."""

    def __init__(self, name: str = ""):
        super().__init__(depth=1, name=name)
        self.depth = float("inf")  # type: ignore[assignment]

    def Full(self) -> bool:
        return False


def stream_all(values: Iterable[T], depth: int = DEFAULT_DEPTH,
               name: str = "") -> Stream[T]:
    """Build a stream pre-loaded with ``values`` (depth grows to fit)."""
    vals = list(values)
    s: Stream[T] = Stream(depth=max(depth, len(vals), 1), name=name)
    for v in vals:
        s.Push(v)
    return s
