"""The kernel entry points the framework calls; port of ``kernels/ops.py``.

Each wrapper keeps the reference's name and keywords.  ``use_pallas``
(the name ``ModelConfig.use_pallas`` carries) selects the hand-written
kernel's wrapper, which launches the CUDA kernel on CUDA tensors and runs
its plain twin on CPU tensors; ``use_pallas=False`` takes the reference
formula (``ref.*``, ``layers._kv_quantize``, ``layers.rmsnorm``).  The
reference's ``interpret`` flag (Pallas interpret mode) has no meaning on
a GPU and is dropped.  ``block_q``/``block_k``/``block_rows`` are the
TPU kernels' VMEM tile sizes; they are accepted for the reference's
signature and do not change the result (the CUDA kernels choose their
own tiles).
"""

from __future__ import annotations

from typing import Optional

from ..models import layers
from . import ref
from .flash_attention import flash_attention, flash_attention_decode_paged
from .kv_quant import kv_quantize
from .rmsnorm_kernel import rmsnorm
from .ssd_scan import ssd_scan
from .stencil import stencil2d
from .treereduce_kernel import tree_row_reduce


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              use_pallas: bool = False, block_q: int = 128,
              block_k: int = 128):
    """q (b, hq, sq, d) against k, v (b, hkv, sk, d); queries aligned to
    the end of the keys."""
    if use_pallas:
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def paged_decode_attention(q, k_pages, v_pages, block_tab, pos, *,
                           window: Optional[int] = None, page_base=None,
                           k_scale_pages=None, v_scale_pages=None,
                           use_pallas: bool = False):
    """Paged-KV decode attention: q (b, hq, sq, d) against (n_pages, hkv,
    page, d) pools gathered through (b, n_blocks) block tables.  sq == 1
    is the plain decode step; sq > 1 a verify span at positions
    pos..pos+sq-1.  ``page_base`` carries ring-of-pages bases;
    ``*_scale_pages`` dequantize int8 pools."""
    kw = dict(window=window, page_base=page_base,
              k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    if use_pallas:
        return flash_attention_decode_paged(q, k_pages, v_pages, block_tab,
                                            pos, **kw)
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tab, pos, **kw)


def ssd(x, dt, A, B, C, *, chunk: int = 64, use_pallas: bool = False):
    """Batched SSD: x (b, s, h, dh), dt (b, s, h), A (h,), B/C (b, s, ds).
    ``use_pallas`` takes kernel B6 (``s % chunk == 0``); otherwise the
    chunked reference over the batch, which pads a ragged tail."""
    if use_pallas:
        return ssd_scan(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_chunked_batch(x, dt, A, B, C, chunk=chunk)[0]


def stencil(x, *, use_pallas: bool = False, block_rows: int = 128):
    """One Jacobi sweep of the 4-point stencil on (H, W); zero boundary."""
    if use_pallas:
        return stencil2d(x)
    return ref.stencil2d_ref(x)


def row_reduce(x, *, op: str = "add", use_pallas: bool = False):
    """Add or max over the last axis of (rows, N)."""
    if use_pallas:
        return tree_row_reduce(x, op=op)
    return ref.rowreduce_ref(x, op=op)


def kv_quant(x, *, use_pallas: bool = False):
    """Row-wise int8 KV quantization: (rows, d) -> (int8, bf16 scales)."""
    if use_pallas:
        return kv_quantize(x)
    return layers._kv_quantize(x)


def fused_rmsnorm(x, w, *, use_pallas: bool = False):
    """RMSNorm of (rows, d) with (1 + w) gains."""
    if use_pallas:
        return rmsnorm(x, w)
    return layers.rmsnorm(x, w)
