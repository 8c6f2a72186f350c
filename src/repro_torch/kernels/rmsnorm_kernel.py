"""Fused RMSNorm: kernel B4's wrapper and plain twin.

``rmsnorm`` is the port of the TPU kernel
``src/repro/kernels/rmsnorm_kernel.py::rmsnorm`` (its ``pallas_call`` at
line 37): ``x * rsqrt(mean(x**2) + eps) * (1 + w)`` per row of (rows, d),
in fp32, stored in x's dtype (the models' zero-centred gains).  On CUDA
tensors it launches ``csrc/rmsnorm.cu``, which reads x once and writes y
once (each row held in registers by a group of warps, several rows per
CTA, as ``rmsnorm_plan`` picks from the shapes); on CPU tensors it runs ``rmsnorm_plain``, the model's own
``models.layers.rmsnorm``.  The order of the sum of squares is free (the
reference's ``mean`` promises none), so kernel and twin agree to fp32
rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import layers
from .build import check_launch, library, on_cpu, require, sm_count

_DTYPES = (torch.float32, torch.bfloat16)
RMS_MAX_VECS = 12       # 16-byte vectors of a row one lane holds (kMaxVecs)
RMS_MAX_WARPS = 8       # warps per row, and per CTA (kMaxWarps)
RMS_CTA_WARPS = 4       # warps per CTA when a row takes fewer


def rmsnorm_plan(rows: int, d: int, x_bytes: int, n_sm: int):
    """(warps_per_row, rows_per_cta) of the kernel for x (rows, d) of
    ``x_bytes``-byte elements on a card of ``n_sm`` SMs, from the shapes
    alone.  A row takes the fewest warps whose lanes hold it in registers
    (16-byte vectors, or scalars when d is not a multiple of one); few
    rows take more warps each, until rows x warps fill four warps per SM.
    (0, 1): the row is too wide for registers, the two-pass kernel."""
    v = 16 // x_bytes
    nvec = d // v if d % v == 0 else d
    wpr = 1
    while wpr < RMS_MAX_WARPS and nvec > 32 * wpr * RMS_MAX_VECS:
        wpr *= 2
    if nvec > 32 * wpr * RMS_MAX_VECS:
        return 0, 1
    while wpr < RMS_MAX_WARPS and rows * wpr < RMS_CTA_WARPS * n_sm:
        wpr *= 2
    return wpr, max(1, RMS_CTA_WARPS // wpr)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``models.layers.rmsnorm``."""
    return layers.rmsnorm(x, w, eps)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("rmsnorm").rmsnorm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: (rows, d); w: (d,).  Returns normalized x in x's dtype.

    CPU tensors run the plain version.  CUDA tensors (x and w each
    float32 or bfloat16, contiguous) launch the kernel on the current
    stream, or raise.  Each launch adds one to ``rmsnorm.launches``."""
    if on_cpu("rmsnorm", x, w):
        return rmsnorm_plain(x, w, eps)
    req = functools.partial(require, "rmsnorm")
    req(x.dim() == 2, f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    req(tuple(w.shape) == (d,), f"w must be ({d},), got {tuple(w.shape)}")
    req(x.dtype in _DTYPES and w.dtype in _DTYPES,
        f"dtypes {x.dtype}/{w.dtype} (kernel takes float32 or bfloat16)")
    for name, t in (("x", x), ("w", w)):
        req(t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{name} must be contiguous and 16-byte aligned")
    wpr, rpc = rmsnorm_plan(rows, d, x.element_size(),
                            sm_count(x.device.index))
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                    float(eps), int(x.dtype == torch.bfloat16),
                    int(w.dtype == torch.bfloat16), wpr, rpc, stream)
    check_launch("rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
