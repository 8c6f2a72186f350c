"""int8 KV quantize / dequantize: the CUDA kernel's wrappers and plain twins.

``kv_quantize`` and ``kv_dequantize`` are the port of the TPU kernels
``src/repro/kernels/kv_quant.py::kv_quantize`` / ``kv_dequantize`` (their
``pallas_call`` at lines 55 and 76), the kernel form of the reference's
``models/layers._kv_quantize`` / ``_kv_dequantize``: per-row symmetric
int8 with one bf16 scale per row.  ``kv_quantize_store`` is the same
quantize fused with the int8 cache write of the reference's decode and
paged append: one launch quantizes a layer's K and V rows and stores them
(values and scales) in their cache rows, which ``kv_store_rows`` computes
on the device.  On CUDA tensors the wrappers launch the hand-written
Hopper kernels of ``csrc/kv_quant.cu`` (built with nvcc for sm_90a at
first use, see ``kernels/build.py``) or raise; on CPU tensors they run
``kv_quantize_plain`` / ``kv_quantize_store_plain`` /
``kv_dequantize_plain``, the same functions in plain PyTorch.  Kernel
and twin agree bit for bit, and the twins agree bit for bit with the JAX
package.

The kernels are bound by bytes, and at decode sizes by their launch;
``csrc/kv_quant.cu`` says how its design meets both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import check_launch, library, on_cpu, require, sm_count

F32 = torch.float32
EPS = 1e-6


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def kv_quant_plan(rows: int, d: int, x_bytes: int, n_sm: int):
    """(lanes per row G, 16-byte vectors per lane NV, threads per CTA) of
    the quantize kernel for ``rows`` rows of d ``x_bytes``-byte elements
    on a card of ``n_sm`` SMs, from the shapes alone.  Many rows: two
    vectors a lane (G a power of two, at most 32), CTAs of 4 warps.  Few
    rows (fewer such CTAs than SMs), if a row has at most 32 vectors: one
    vector a lane and CTAs of 2 warps, to spread the rows over the SMs."""
    nvec = d * x_bytes // 16
    lanes = min(32, _pow2_at_least(-(-nvec // 2)))
    nv = _pow2_at_least(-(-nvec // lanes))
    if -(-rows // (4 * 32 // lanes)) < n_sm and nvec <= 32:
        return _pow2_at_least(nvec), 1, 64
    return lanes, nv, 128


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


def kv_store_rows(lead: torch.Tensor, slot: torch.Tensor, n_heads: int,
                  n_slots: int, keep: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Destination rows for ``kv_quantize_store`` in a cache leaf of shape
    (n_lead, n_heads, n_slots, d) viewed as (-1, d): for each entry of
    ``lead`` / ``slot`` (equal shapes) and each head h, the flat row
    ``(lead * n_heads + h) * n_slots + slot``; shape ``lead.shape +
    (n_heads,)``, int64, on the device of ``lead``, -1 (dropped) where
    ``keep`` is False.  A dense slot cache (b, hkv, S, d) takes ``lead``
    = the batch row and ``slot`` its cache position; a page pool
    (n_pages, hkv, page, d) takes the page id and the offset in it."""
    heads = torch.arange(n_heads, device=lead.device)
    rows = (lead.to(torch.int64)[..., None] * n_heads + heads) * n_slots \
        + slot.to(torch.int64)[..., None]
    if keep is not None:
        rows = torch.where(keep[..., None], rows, -1)
    return rows


def kv_quantize_store_plain(k: torch.Tensor, v: torch.Tensor,
                            k_dst: torch.Tensor, v_dst: torch.Tensor,
                            ks_dst: torch.Tensor, vs_dst: torch.Tensor,
                            dst_row: torch.Tensor) -> None:
    """``kv_quantize_plain`` of the rows of k and v (..., d), each row i
    written in place to flat row ``dst_row[i]`` of the int8 leaf
    ``k_dst`` / ``v_dst`` (viewed as (-1, d)) and its scale to the same
    row of ``ks_dst`` / ``vs_dst``; rows outside [0, n_dst) are dropped,
    as the reference's ``mode="drop"`` scatter drops them."""
    d = k.shape[-1]
    rows = dst_row.reshape(-1).to(torch.int64)
    keep = (rows >= 0) & (rows < k_dst.numel() // d)
    for x, q_dst, s_dst in ((k, k_dst, ks_dst), (v, v_dst, vs_dst)):
        q, s = kv_quantize_plain(x.reshape(-1, d))
        q_dst.view(-1, d)[rows[keep]] = q[keep]
        s_dst.view(-1, 1)[rows[keep]] = s[keep]


def kv_dequantize_plain(q: torch.Tensor, s: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """(q * s) in fp32, cast once to ``dtype``."""
    return (q.to(F32) * s.to(F32)).to(dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = library("kv_quant")
    quant, store, dequant = (lib.kv_quantize, lib.kv_quantize_store,
                             lib.kv_dequantize)
    plan = ctypes.POINTER(ctypes.c_int)
    quant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        plan, ctypes.c_void_p]
    store.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [plan, ctypes.c_void_p]
    dequant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p]
    quant.restype = store.restype = dequant.restype = ctypes.c_int
    return quant, store, dequant


def _plan_arg(plan):
    """A plan as the C entry points take it (an int array)."""
    return (ctypes.c_int * len(plan))(*plan)


def _require_rows(fn: str, *xs: torch.Tensor) -> int:
    """The kernel's input rule: float32 or bfloat16 rows (..., d) of whole
    16-byte vectors, d at most 512, contiguous and 16-byte aligned.
    Returns d."""
    d = xs[0].shape[-1]
    for x in xs:
        require(fn, x.dtype in (torch.float32, torch.bfloat16)
                and x.dtype == xs[0].dtype,
                f"input dtype {x.dtype} (kernel takes float32 or bfloat16, "
                "one for all inputs)")
        require(fn, x.is_contiguous() and x.data_ptr() % 16 == 0,
                "inputs must be contiguous and 16-byte aligned")
    vec = 16 // xs[0].element_size()
    require(fn, d % vec == 0 and 0 < d <= 512,
            f"row width {d} must be a multiple of {vec} (16 bytes of "
            f"{xs[0].dtype}), at most 512")
    return d


def kv_quantize(x: torch.Tensor):
    """Per-row int8 quantization: x (rows, d) -> (int8 (rows, d), bf16
    (rows, 1)).

    CPU tensors run the plain version.  CUDA tensors (x float32 or
    bfloat16, contiguous, rows of whole 16-byte vectors, d at most 512)
    launch the kernel on the current stream, or raise.  Each launch adds
    one to ``kv_quantize.launches``."""
    fn = "kv_quantize"
    if on_cpu(fn, x):
        return kv_quantize_plain(x)
    require(fn, x.dim() == 2, f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    _require_rows(fn, x)
    quant, _, _ = _kernels()
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = _plan_arg(kv_quant_plan(rows, d, x.element_size(),
                                   sm_count(x.device.index)))
    check_launch(fn, quant(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                           d, int(x.dtype == torch.bfloat16), plan, stream))
    kv_quantize.launches += 1
    return q, s


def kv_quantize_store(k: torch.Tensor, v: torch.Tensor,
                      k_dst: torch.Tensor, v_dst: torch.Tensor,
                      ks_dst: torch.Tensor, vs_dst: torch.Tensor,
                      dst_row: torch.Tensor) -> None:
    """Quantize K and V rows (..., d) and store them in their cache rows,
    in place, in one launch: row i of k goes to flat row ``dst_row[i]``
    of the int8 leaf ``k_dst`` (viewed as (-1, d)) and its bf16 scale to
    the same row of ``ks_dst``; v likewise into ``v_dst`` / ``vs_dst``.
    Rows outside [0, n_dst) are dropped.  ``dst_row`` (n,) int64 comes
    from ``kv_store_rows``; nothing on the device is read on the host.

    CPU tensors run ``kv_quantize_store_plain``.  CUDA tensors (k and v as
    ``kv_quantize`` takes them, of one shape; contiguous int8 leaves of
    one shape, 8-byte aligned, and bf16 scale leaves of one row each)
    launch the kernel on the current stream, or raise.  Each launch adds
    one to ``kv_quantize_store.launches``."""
    fn = "kv_quantize_store"
    if on_cpu(fn, k, v, k_dst, v_dst, ks_dst, vs_dst, dst_row):
        return kv_quantize_store_plain(k, v, k_dst, v_dst, ks_dst, vs_dst,
                                       dst_row)
    require(fn, k.shape == v.shape, f"k {tuple(k.shape)} and v "
            f"{tuple(v.shape)} differ")
    d = _require_rows(fn, k, v)
    n = k.numel() // d
    require(fn, dst_row.dtype == torch.int64 and dst_row.numel() == n
            and dst_row.is_contiguous(),
            f"dst_row must be {n} contiguous int64 rows")
    for q_dst, s_dst in ((k_dst, ks_dst), (v_dst, vs_dst)):
        require(fn, q_dst.dtype == torch.int8 and q_dst.shape == k_dst.shape
                and q_dst.shape[-1] == d and q_dst.is_contiguous()
                and q_dst.data_ptr() % 8 == 0,
                f"int8 leaves must be contiguous (..., {d}) of one shape, "
                "8-byte aligned")
        require(fn, s_dst.dtype == torch.bfloat16 and s_dst.is_contiguous()
                and s_dst.shape == q_dst.shape[:-1] + (1,),
                "scale leaves must be contiguous bf16 (..., 1) beside "
                "their int8 leaves")
    _, store, _ = _kernels()
    plan = _plan_arg(kv_quant_plan(2 * n, d, k.element_size(),
                                   sm_count(k.device.index)))
    stream = torch.cuda.current_stream(k.device).cuda_stream
    check_launch(fn, store(k.data_ptr(), v.data_ptr(), k_dst.data_ptr(),
                           v_dst.data_ptr(), ks_dst.data_ptr(),
                           vs_dst.data_ptr(), dst_row.data_ptr(), n,
                           k_dst.numel() // d, d,
                           int(k.dtype == torch.bfloat16), plan, stream))
    kv_quantize_store.launches += 1


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
    _, _, dequant = _kernels()
    out = torch.empty((rows, d), dtype=dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check_launch(fn, dequant(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                             rows, d, int(dtype == torch.bfloat16), stream))
    kv_dequantize.launches += 1
    return out


kv_quantize.launches = 0
kv_quantize_store.launches = 0
kv_dequantize.launches = 0
