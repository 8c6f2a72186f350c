"""The hlslib core, PyTorch port.

F2 context.py    portable host runtime (Context/Program/Kernel/Buffer)
F3 dataflow.py   multi-PE dataflow emulation (+ pipeline.py compiled mode)
F4 stream.py     bounded thread-safe FIFO channels
F5 datapack.py   typed wide data paths
F6 shiftreg.py   shift registers with parallel taps
F7 treereduce.py explicit balanced tree reduction
health.py        liveness and straggler detection for supervisors
trace.py         lifecycle events and nested host spans on one clock,
                 anchored to the profiler's (serving and training)

collectives.py   tree/ring schedules over a process group (F7 at mesh
                 level)

The reference's TPU VMEM sizing helpers (``block_shape_2d``,
``fits_vmem``) have no counterpart here.
"""

from .stream import Stream, UnboundedStream, StreamClosed, stream_all
from .dataflow import DataflowContext, DataflowError, PE, run_cyclic_dataflow
from .datapack import (DataPack, LANE, round_up, pad_to_lanes, padded_vocab,
                       padding_waste, assert_lane_aligned)
from .shiftreg import ShiftReg, shift_window, causal_conv_shiftreg, causal_conv_ref
from .treereduce import (Add, Mul, Max, Min, LogSumExp, tree_reduce,
                         serial_reduce, tree_reduce_fn)
from .context import Context, Program, Kernel, Buffer, Access, MemoryBank
from .health import Heartbeat, StragglerDetector
from . import pipeline
