"""Mamba2 SSD chunked scan: kernel B6's wrapper and plain twin.

``ssd_scan`` is the port of the TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_scan`` (its ``pallas_call`` at line
88): per (batch, head), the chunked state-space-duality form of the
Mamba2 recurrence, a causal decayed "attention" term within each chunk
of ``chunk`` positions plus the (ds, dh) state carried across chunks.
Like the TPU kernel it takes ``s % chunk == 0`` and returns y only (no
final state: serving prefill takes the chunked reference instead).

On CUDA tensors (fp32, contiguous) it launches ``csrc/ssd_scan.cu``, the
chunk-parallel form in four kernels (``ssd_plan`` gives their grids and
the fp32 scratch the wrapper allocates); on CPU tensors it runs
``ssd_scan_plain``, the chunked formula of the TPU
kernel's body over every (batch, head) at once with a loop over chunks
(``ref.ssd_chunked_batch``).  The two sum in different orders, so they
agree to fp32 rounding (the reference's tests hold the kernel to the
recurrence at rtol = atol = 2e-4).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import check_launch, library, on_cpu, require

F32 = torch.float32
_MAX_DS = 128
_MAX_CHUNK = 1024
SSD_TILE = 64           # rows of the kernels' i and j tiles (kT)


def _check_chunk(s: int, chunk: int) -> None:
    if s % chunk:
        raise ValueError(f"seq {s} not a multiple of chunk {chunk}")


def ssd_scan_plain(x, dt, A, B, C, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x (b, s, h, dh), dt (b, s, h),
    A (h,), B, C (b, s, ds); returns y (b, s, h, dh) in x's dtype."""
    _check_chunk(x.shape[1], chunk)
    return ref.ssd_chunked_batch(x, dt, A, B, C, chunk)[0]


def ssd_plan(b: int, s: int, h: int, dh: int, ds: int, chunk: int) -> dict:
    """The kernels' layout for these shapes, from the shapes alone: the dh
    slab of a CTA (``dhs``), the CTAs of each of the four kernels, and
    the fp32 scratch: G = C·Bᵀ per (b, chunk) over chunks padded to
    ``qp`` rows, the chunk states S (b, h, nc, ds, dh) and each chunk's
    cum_last L (b, h, nc)."""
    nc, nqt = s // chunk, -(-chunk // SSD_TILE)
    qp = nqt * SSD_TILE
    dhs = 64 if dh % 64 == 0 else 32 if dh % 32 == 0 else 16
    slabs = dh // dhs
    shapes = {"G": (b, nc, qp, qp), "S": (b, h, nc, ds, dh), "L": (b, h, nc)}
    ctas = {"cb": nqt * (nqt + 1) // 2 * nc * b,
            "state": nc * slabs * h * b,
            "pass": -(-(ds * dh // 4) // 256) * h * b,
            "out": nc * nqt * slabs * h * b}
    n_scratch = sum(torch.Size(v).numel() for v in shapes.values())
    return {"dhs": dhs, "qp": qp, "n_chunks": nc, "scratch": shapes,
            "ctas": ctas, "scratch_bytes": 4 * n_scratch}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("ssd_scan").ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 64
             ) -> torch.Tensor:
    """x: (b, s, h, dh); dt: (b, s, h); A: (h,); B, C: (b, s, ds)
    [ngroups = 1].  Returns y: (b, s, h, dh).  ``s % chunk == 0``, else
    ``ValueError``.

    CPU tensors run the plain version.  CUDA tensors (all float32 and
    contiguous; ds a multiple of 16 up to 128, dh a multiple of 16,
    chunk <= 1024) launch the kernel on the current stream, or raise.
    Each launch adds one to ``ssd_scan.launches``."""
    _check_chunk(x.shape[1], chunk)
    if on_cpu("ssd_scan", x, dt, A, B, C):
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    req = functools.partial(require, "ssd_scan")
    req(x.dim() == 4, f"x must be (b, s, h, dh), got {tuple(x.shape)}")
    b, s, h, dh = x.shape
    ds = B.shape[-1]
    for name, t, shape in (("dt", dt, (b, s, h)), ("A", A, (h,)),
                           ("B", B, (b, s, ds)), ("C", C, (b, s, ds))):
        req(tuple(t.shape) == shape,
            f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        req(t.dtype == F32 and t.is_contiguous(),
            f"{name} must be contiguous float32 (got {t.dtype})")
    for name, t in (("x", x), ("B", B), ("C", C)):     # 16-byte tile copies
        req(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    req(ds % 16 == 0 and 0 < ds <= _MAX_DS,
        f"ds {ds} (kernel takes multiples of 16 up to {_MAX_DS})")
    req(dh % 16 == 0 and dh > 0, f"dh {dh} (kernel takes multiples of 16)")
    req(0 < chunk <= _MAX_CHUNK, f"chunk {chunk} (kernel takes <= "
        f"{_MAX_CHUNK})")
    req(max(b, h, s // chunk) <= 65535,
        f"b {b} / h {h} / chunks {s // chunk} exceed the grid")
    plan = ssd_plan(b, s, h, dh, ds, chunk)
    y = torch.empty_like(x)
    G, S, L = (torch.empty(plan["scratch"][k], dtype=F32, device=x.device)
               for k in ("G", "S", "L"))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), y.data_ptr(), G.data_ptr(), S.data_ptr(),
                    L.data_ptr(), b, s, h, dh, ds, chunk, plan["dhs"],
                    stream)
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
