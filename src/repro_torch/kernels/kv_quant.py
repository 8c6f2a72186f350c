"""int8 KV quantize / dequantize: the CUDA kernel's wrappers and plain twins.

``kv_quantize`` and ``kv_dequantize`` are the port of the TPU kernels
``src/repro/kernels/kv_quant.py::kv_quantize`` / ``kv_dequantize`` (their
``pallas_call`` at lines 55 and 76), the kernel form of the reference's
``models/layers._kv_quantize`` / ``_kv_dequantize``: per-row symmetric
int8 with one bf16 scale per row.  On CUDA tensors they launch the
hand-written Hopper kernels of ``csrc/kv_quant.cu`` (built with nvcc for
sm_90a at first use, see ``kernels/build.py``) or raise; on CPU tensors
they run ``kv_quantize_plain`` / ``kv_dequantize_plain``, the same
functions in plain PyTorch.  Kernel and twin agree bit for bit, and the
twins agree bit for bit with the JAX package.

Both kernels are bound by bytes; ``csrc/kv_quant.cu`` says how.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check_launch, library, on_cpu, require

F32 = torch.float32
EPS = 1e-6


def kv_quantize_plain(x: torch.Tensor):
    """x: (rows, d) -> (int8 (rows, d), bf16 scales (rows, 1)).  fp32
    row max, ``scale = max(amax, 1e-6) / 127``, ``q = clip(round(x /
    scale), -127, 127)`` rounding half to even, the scale stored in bf16
    (the division uses the fp32 scale, as the reference does)."""
    xf = x.to(F32)
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=EPS)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not the reference's division.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def kv_dequantize_plain(q: torch.Tensor, s: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """(q * s) in fp32, cast once to ``dtype``."""
    return (q.to(F32) * s.to(F32)).to(dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = library("kv_quant")
    quant, dequant = lib.kv_quantize, lib.kv_dequantize
    quant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    dequant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
    quant.restype = dequant.restype = ctypes.c_int
    return quant, dequant


def kv_quantize(x: torch.Tensor):
    """Per-row int8 quantization: x (rows, d) -> (int8 (rows, d), bf16
    (rows, 1)).

    CPU tensors run the plain version.  CUDA tensors (x float32 or
    bfloat16, contiguous, d a multiple of 4 and at most 512) launch the
    kernel on the current stream, or raise.  Each launch adds one to
    ``kv_quantize.launches``."""
    fn = "kv_quantize"
    if on_cpu(fn, x):
        return kv_quantize_plain(x)
    require(fn, x.dim() == 2, f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    require(fn, x.dtype in (torch.float32, torch.bfloat16),
            f"x dtype {x.dtype} (kernel takes float32 or bfloat16)")
    require(fn, x.is_contiguous() and x.data_ptr() % 16 == 0,
            "x must be contiguous and 16-byte aligned")
    require(fn, d % 4 == 0 and d <= 512,
            f"row width {d} must be a multiple of 4, at most 512")
    quant, _ = _kernels()
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch(fn, quant(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                           d, int(x.dtype == torch.bfloat16), stream))
    kv_quantize.launches += 1
    return q, s


def kv_dequantize(q: torch.Tensor, s: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """q (rows, d) int8 times s (rows, 1) bf16 -> (rows, d) ``dtype``.

    CPU tensors run the plain version.  CUDA tensors (contiguous, d a
    multiple of 8, ``dtype`` float32 or bfloat16) launch the kernel on the
    current stream, or raise.  Each launch adds one to
    ``kv_dequantize.launches``."""
    fn = "kv_dequantize"
    if on_cpu(fn, q, s):
        return kv_dequantize_plain(q, s, dtype)
    require(fn, q.dim() == 2 and q.dtype == torch.int8,
            f"q must be (rows, d) int8, got {tuple(q.shape)} {q.dtype}")
    rows, d = q.shape
    require(fn, s.dtype == torch.bfloat16 and tuple(s.shape) == (rows, 1),
            "s must be (rows, 1) bf16")
    require(fn, dtype in (torch.float32, torch.bfloat16),
            f"output dtype {dtype} (kernel writes float32 or bfloat16)")
    require(fn, q.is_contiguous() and s.is_contiguous()
            and q.data_ptr() % 8 == 0,
            "q and s must be contiguous, q 8-byte aligned")
    require(fn, d % 8 == 0, f"row width {d} must be a multiple of 8")
    _, dequant = _kernels()
    out = torch.empty((rows, d), dtype=dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check_launch(fn, dequant(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                             rows, d, int(dtype == torch.bfloat16), stream))
    kv_dequantize.launches += 1
    return out


kv_quantize.launches = 0
kv_dequantize.launches = 0
