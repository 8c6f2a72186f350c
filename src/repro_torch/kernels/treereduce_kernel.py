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

from .build import check_launch, library, on_cpu, require, sm_count

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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# residues per CTA of the split pass (csrc/treereduce.cu kSplitResidues):
# a row split over C CTAs leaves Q = 512 C partials in the scratch.
TREE_SPLIT_RESIDUES = 512
# each residue's tree spans at least this many elements, so the scratch
# stays an eighth of the row or less.
TREE_MIN_LEAVES = 8


def tree_splits(rows: int, n: int, n_sm: int) -> int:
    """How many CTAs share one row: 1 (one warp per row) unless the rows
    are too few to give every SM two CTAs, then doubled until they do or
    a residue's tree would span fewer than ``TREE_MIN_LEAVES`` elements.
    Shapes and the SM count only."""
    p2 = 1 << (n - 1).bit_length()
    c = 1
    while (rows * c < 2 * n_sm
           and p2 // (TREE_SPLIT_RESIDUES * 2 * c) >= TREE_MIN_LEAVES):
        c *= 2
    return c


def tree_row_reduce(x: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Reduce the last axis of (rows, N) with a guaranteed balanced tree.

    Returns (rows,) in x's dtype.  CPU tensors run the plain version.
    CUDA tensors (float32 or bfloat16, contiguous, N <= 2**24) launch the
    kernel on the current stream, or raise: ``tree_splits`` CTAs share a
    row, and with more than one a second kernel halves their fp32
    partials.  Each call adds one to ``tree_row_reduce.launches``."""
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
    n_split = tree_splits(rows, n, sm_count(x.device.index))
    part = None
    if n_split > 1:     # per-residue partials, halved by the second kernel
        part = torch.empty((rows, TREE_SPLIT_RESIDUES * n_split), dtype=F32,
                           device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), out.data_ptr(),
                    part.data_ptr() if part is not None else None, rows, n,
                    n_split, int(op == "max"), int(x.dtype == torch.bfloat16),
                    stream)
    check_launch("tree_row_reduce", err)
    tree_row_reduce.launches += 1
    return out


tree_row_reduce.launches = 0
