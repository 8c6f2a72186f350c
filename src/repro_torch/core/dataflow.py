"""F3 — multi-PE dataflow emulation (paper §II-C, Listings 3 & 4).

The paper's central observation: a DATAFLOW region behaves differently in
software (functions run *sequentially* to completion) and in hardware
(processing elements run *concurrently*, synchronized by bounded FIFOs).
For cyclic dataflow — e.g. iterative stencils that re-read DRAM written by
a downstream PE — the sequential emulation silently computes different
results than the hardware will.

hlslib fixes this with ``HLSLIB_DATAFLOW_FUNCTION``: in software each
annotated call launches a thread; ``HLSLIB_DATAFLOW_FINALIZE`` joins them.
Bounded thread-safe streams then enforce hardware-faithful lock-step
progress, and channel-timeout warnings surface deadlocks caused by
insufficient FIFO depth.

PyTorch port: a copy of the JAX package's ``core/dataflow.py``, which is
pure Python.  ``DataflowContext`` is the Python equivalent of the macro
set.  In ``mode="software"`` (hardware-faithful emulation) each PE runs
in a thread, communicating over bounded ``repro_torch.core.stream.Stream``
objects; ``mode="sequential"`` reproduces the *naive* C++-compilation
behavior the paper warns about (each PE runs to completion in call order,
streams unbounded).  ``launch/serve.py`` runs its producer and batcher
PEs under it; ``run_cyclic_dataflow`` is the paper's Listing 3/4 program,
on which the two modes diverge.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Literal, Optional, Tuple

from .stream import Stream, UnboundedStream

Mode = Literal["software", "sequential"]


@dataclass
class PE:
    """One processing element: a callable plus its (positional) arguments.

    Stream arguments are detected by type; everything else is passed
    through untouched (pointers-to-DRAM in the paper ≈ numpy/JAX arrays
    or any Python object here).
    """
    fn: Callable[..., Any]
    args: Tuple[Any, ...]
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = getattr(self.fn, "__name__", "pe")

    @property
    def in_streams(self) -> List[Stream]:
        return [a for a in self.args if isinstance(a, Stream)]


class DataflowError(RuntimeError):
    pass


class DataflowContext:
    """``HLSLIB_DATAFLOW_INIT`` … ``HLSLIB_DATAFLOW_FINALIZE`` as a context.

    Usage (mirrors the paper's Listing 4)::

        with DataflowContext() as df:            # HLSLIB_DATAFLOW_INIT
            df.function(Read, mem0, s0)          # HLSLIB_DATAFLOW_FUNCTION
            df.function(Compute, s0, s1)
            df.function(Write, s1, mem1)
        # __exit__                               # HLSLIB_DATAFLOW_FINALIZE

    In ``software`` mode every ``df.function`` launches a daemon thread;
    ``__exit__`` joins them and re-raises the first PE exception.  In
    ``sequential`` mode calls execute immediately in order, and bounded
    streams are transparently *unbounded-ified* — reproducing what naive
    C++ emulation does, including its wrong answers for cyclic dataflow.
    """

    def __init__(self, mode: Mode = "software",
                 join_timeout: Optional[float] = 60.0):
        if mode not in ("software", "sequential"):
            raise ValueError(f"unknown dataflow mode: {mode}")
        self.mode = mode
        self.join_timeout = join_timeout
        self._threads: List[threading.Thread] = []
        self._pes: List[PE] = []
        self._errors: List[BaseException] = []
        self._errors_lock = threading.Lock()
        self._finalized = False

    # -- HLSLIB_DATAFLOW_FUNCTION ------------------------------------------------

    def function(self, fn: Callable[..., Any], *args: Any,
                 name: str = "") -> PE:
        if self._finalized:
            raise DataflowError("DataflowContext already finalized")
        pe = PE(fn=fn, args=args, name=name)
        self._pes.append(pe)
        if self.mode == "sequential":
            # Naive emulation: run to completion now.  Bounded streams would
            # deadlock immediately (producer fills depth-k FIFO with no
            # consumer running), so sequential mode lifts the bound — exactly
            # the "assuming streams are unbounded in emulation" caveat in the
            # paper's §II-C analysis.
            for a in args:
                if isinstance(a, Stream) and not isinstance(a, UnboundedStream):
                    a.depth = float("inf")  # type: ignore[assignment]
            fn(*args)
        else:
            t = threading.Thread(target=self._run_pe, args=(pe,),
                                 name=f"pe:{pe.name}", daemon=True)
            self._threads.append(t)
            t.start()
        return pe

    def _run_pe(self, pe: PE) -> None:
        try:
            pe.fn(*pe.args)
        except BaseException as e:  # noqa: BLE001 - surfaced at finalize
            with self._errors_lock:
                self._errors.append(e)
            # Unblock peers waiting on streams this PE touches, so finalize
            # does not hang when one PE dies mid-pipeline.
            for a in pe.args:
                if isinstance(a, Stream):
                    a.close()

    # -- HLSLIB_DATAFLOW_FINALIZE --------------------------------------------------

    def finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        for t in self._threads:
            t.join(self.join_timeout)
            if t.is_alive():
                # Name the stuck PE — the dataflow-level analogue of the
                # stream timeout warning.
                with self._errors_lock:
                    self._errors.append(DataflowError(
                        f"PE '{t.name}' did not terminate within "
                        f"{self.join_timeout}s — deadlock? Check stream "
                        f"depths (stats: "
                        f"{[s.stats for p in self._pes for s in p.in_streams]})"))
        if self._errors:
            raise self._errors[0]

    def __enter__(self) -> "DataflowContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is None:
            self.finalize()
        # On exception inside the with-body, skip join: streams may be
        # wedged.  Close all streams to release threads.
        else:
            for pe in self._pes:
                for a in pe.args:
                    if isinstance(a, Stream):
                        a.close()


# -- the paper's canonical 3-PE Read/Compute/Write shape -----------------------


def read_pe(mem, s: Stream, T: int, N: int) -> None:
    """Paper Listing 3 ``Read``: T outer iterations streaming N elements."""
    for _ in range(T):
        for i in range(N):
            s.Push(mem[i])


def write_pe(s: Stream, mem, T: int, N: int) -> None:
    """Paper Listing 3 ``Write``: T outer iterations draining N elements."""
    for _ in range(T):
        for i in range(N):
            mem[i] = s.Pop()


def compute_pe(s_in: Stream, s_out: Stream, fn: Callable[[Any], Any],
               T: int, N: int) -> None:
    for _ in range(T):
        for _ in range(N):
            s_out.Push(fn(s_in.Pop()))


def run_cyclic_dataflow(mem, fn: Callable[[Any], Any], T: int, N: int,
                        mode: Mode = "software", depth: int = 1):
    """The paper's Listing 3/4 program: Read → Compute → Write where Read
    and Write alias the *same* memory (cyclic dataflow through DRAM).

    ``mode="software"`` (hlslib emulation): iteration ``t`` of Read observes
    values written by iteration ``t-1`` of Write — the hardware behavior.
    ``mode="sequential"`` (naive emulation): Read runs all T·N iterations
    first, so every iteration recomputes from the *initial* memory — the
    divergent software behavior the paper warns about.

    Returns ``mem`` mutated in place (a list, a 1-D numpy array or tensor).
    """
    s0: Stream = Stream(depth=depth, name="s0")
    s1: Stream = Stream(depth=depth, name="s1")
    with DataflowContext(mode=mode) as df:
        df.function(read_pe, mem, s0, T, N)
        df.function(compute_pe, s0, s1, fn, T, N)
        df.function(write_pe, s1, mem, T, N)
    return mem
