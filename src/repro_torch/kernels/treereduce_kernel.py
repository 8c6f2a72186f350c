"""Row-wise balanced tree reduction (paper §III-D): kernel B7's wrapper
and plain twin.

``tree_row_reduce`` is the port of the TPU kernel
``src/repro/kernels/treereduce_kernel.py::tree_row_reduce`` (its
``pallas_call`` at line 57): add or max over the last axis of (rows, N),
N padded to a power of two with the operator identity, reduced in fp32
by balanced halving (element ``i`` combines with ``i + half`` at every
level), stored in x's dtype.  The combine order is static and balanced,
so the result is bit-reproducible: the CUDA kernel (``csrc/treereduce.cu``)
keeps that pairing and agrees with ``tree_row_reduce_plain`` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import check_launch, library, on_cpu, require

F32 = torch.float32
_OPS = {"add": (torch.add, 0.0), "max": (torch.maximum, -math.inf)}


def tree_row_reduce_plain(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Plain PyTorch version of the kernel: identity padding to a power
    of two in x's dtype, fp32 halving, result in x's dtype."""
    combine, ident = _OPS[op]
    rows, n = x.shape
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        x = torch.cat([x, torch.full((rows, p2 - n), ident, dtype=x.dtype,
                                     device=x.device)], dim=1)
    out_dtype = x.dtype
    x = x.to(F32)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = combine(x[:, :half], x[:, half:])
    return x[:, 0].to(out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("treereduce").tree_row_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tree_row_reduce(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Reduce the last axis of (rows, N) with a guaranteed balanced tree.

    Returns (rows,) in x's dtype.  CPU tensors run the plain version.
    CUDA tensors (float32 or bfloat16, contiguous, N <= 2**24) launch the
    kernel on the current stream, or raise.  Each launch adds one to
    ``tree_row_reduce.launches``."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r} (add or max)")
    if on_cpu("tree_row_reduce", x):
        return tree_row_reduce_plain(x, op)
    req = functools.partial(require, "tree_row_reduce")
    req(x.dim() == 2 and x.shape[1] > 0,
        f"x must be (rows, N) with N > 0, got {tuple(x.shape)}")
    rows, n = x.shape
    req(n <= 1 << 24, f"row length {n} > 2**24")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"dtype {x.dtype} (kernel takes float32 or bfloat16)")
    req(x.is_contiguous(), "x must be contiguous")
    out = torch.empty(rows, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), out.data_ptr(), rows, n,
                    int(op == "max"), int(x.dtype == torch.bfloat16), stream)
    check_launch("tree_row_reduce", err)
    tree_row_reduce.launches += 1
    return out


tree_row_reduce.launches = 0
