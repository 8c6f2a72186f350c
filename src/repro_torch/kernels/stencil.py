"""2D 4-point stencil (paper Listing 6): kernel B8's wrapper and plain twin.

``stencil2d`` is the port of the TPU kernel
``src/repro/kernels/stencil.py::stencil2d`` (its ``pallas_call`` at line
68): one Jacobi sweep ``0.25 * (N + S + W + E)`` with a zero boundary,
computed in fp32 and stored in x's dtype.  On CUDA tensors it launches
``csrc/stencil.cu``; on CPU tensors it runs ``stencil2d_plain``.  The
kernel and the twin add the four taps in the same order, so they agree
bit for bit.  ``stencil2d_iterated`` is the cyclic-dataflow workload of
paper §II-C: the same memory read and written every sweep, here two
device buffers used in turn, one launch per sweep.

The Pallas kernel's row blocks (and its padding of H to a block
multiple) are a TPU tiling detail and are not copied; the result is
defined by ``ref.stencil2d_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import check_launch, library, on_cpu, require

F32 = torch.float32


def stencil2d_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32, taps summed north,
    south, west, east, then scaled by 0.25, stored in x's dtype."""
    xp = F.pad(x.to(F32), (1, 1, 1, 1))
    s = ((xp[:-2, 1:-1] + xp[2:, 1:-1]) + xp[1:-1, :-2]) + xp[1:-1, 2:]
    return (s * 0.25).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("stencil").stencil2d
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor) -> None:
    req = functools.partial(require, "stencil2d")
    req(x.dim() == 2, f"x must be (H, W), got {tuple(x.shape)}")
    req(x.dtype in (torch.float32, torch.bfloat16),
        f"dtype {x.dtype} (kernel takes float32 or bfloat16)")
    req(x.is_contiguous() and x.data_ptr() % 16 == 0,
        "x must be contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    H, W = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), out.data_ptr(), H, W,
                    int(x.dtype == torch.bfloat16), stream)
    check_launch("stencil2d", err)
    stencil2d.launches += 1
    return out


def stencil2d(x: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep of the 4-point stencil; zero boundary.

    x: (H, W).  CPU tensors run the plain version.  CUDA tensors (float32
    or bfloat16, contiguous) launch the kernel on the current stream, or
    raise.  Each launch adds one to ``stencil2d.launches``."""
    if on_cpu("stencil2d", x):
        return stencil2d_plain(x)
    _check(x)
    return _launch(x, torch.empty_like(x))


stencil2d.launches = 0


def stencil2d_iterated(x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` sweeps (the cyclic-dataflow workload).  On the card two
    buffers take turns as input and output, one launch per sweep; x is
    not written."""
    if iters <= 0:
        return x.clone()
    if on_cpu("stencil2d_iterated", x):
        for _ in range(iters):
            x = stencil2d_plain(x)
        return x
    _check(x)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    for i in range(iters):
        src = _launch(src, bufs[i % 2])
    return src
