"""Mamba2 block (SSD, state-space duality, arXiv:2405.21060); port of
``models/ssm.py``.

* The depthwise causal conv is a 4-tap shift register: training and
  prefill use the windowed form (``_conv_train``), one-token decode
  carries the register's K - 1 raw inputs in the cache.
* The chunked SSD scan goes through ``kernels.ops.ssd``: with
  ``cfg.use_pallas`` kernel B6 (``kernels/ssd_scan.py``, the CUDA kernel
  on the card), otherwise the chunked reference ``ref.ssd_chunked_batch``.
* Decode updates the (h, ds, hd) state in O(1) per token.

Rounding follows the reference: the conv output is stored in the
activations' dtype, the scan runs in fp32, y is cast to the
activations' dtype before the gate and the gate product is taken in it;
the decode state and conv window stay fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, local_region
from ..kernels import ops, ref
from .layers import rmsnorm
from .params import Decl

F32 = torch.float32


def mamba2_decls(cfg, stack: Tuple[int, ...] = ()) -> Dict[str, Decl]:
    d, din, ds, h, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.ssm_conv)
    conv_dim = din + 2 * ds
    ax = ("stack",) * len(stack)
    return {
        "norm": Decl(stack + (d,), ax + ("embed",), init="zeros"),
        # in_proj -> [z (din) | xBC (din + 2 ds) | dt (h)]
        "w_in": Decl(stack + (d, 2 * din + 2 * ds + h),
                     ax + ("embed", "d_inner")),
        "conv_w": Decl(stack + (K, conv_dim), ax + ("conv", "d_inner"),
                       std=0.5),
        "conv_b": Decl(stack + (conv_dim,), ax + ("d_inner",), init="zeros"),
        "A_log": Decl(stack + (h,), ax + ("ssm_heads",), init="zeros"),
        "D": Decl(stack + (h,), ax + ("ssm_heads",), init="ones"),
        "dt_bias": Decl(stack + (h,), ax + ("ssm_heads",), init="zeros"),
        "gate_norm": Decl(stack + (din,), ax + ("d_inner",), init="zeros"),
        "w_out": Decl(stack + (din, d), ax + ("d_inner", "embed")),
    }


def _split_in(cfg, zxbcdt):
    din, ds = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * ds]
    dt = zxbcdt[..., 2 * din + 2 * ds:]
    return z, xbc, dt


def _conv_train(xbc, w, b):
    """Depthwise causal conv over time, windowed shift-register form:
    xbc (b, s, C), w (K, C).  K shifted adds in fp32, SiLU, stored in
    xbc's dtype."""
    K, s = w.shape[0], xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=F32, device=xbc.device)
    for k in range(K):                       # static taps
        shift = K - 1 - k
        xs = F.pad(xbc, (0, 0, shift, 0))[:, :s]
        out = out + xs.to(F32) * w[k].to(F32)
    return F.silu(out + b.to(F32)).to(xbc.dtype)


def _scan_inputs(cfg, p, xbc, dt_raw):
    """x (b, s, h, hd), B, C (b, s, ds) of the conv output and dt, A."""
    b, s, _ = xbc.shape
    din, ds = cfg.d_inner, cfg.ssm_state
    x_ssm = xbc[..., :din].reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    B = xbc[..., din:din + ds]
    C = xbc[..., din + ds:]
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    return x_ssm, B, C, dt, A


def _out(cfg, p, x, y, x_ssm, z):
    """Skip term, gate, norm, out-projection and residual."""
    b, s, _ = x.shape
    y = y + p["D"].to(F32)[None, None, :, None] * x_ssm.to(F32)
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z.to(F32)).to(x.dtype), p["gate_norm"])
    return x + constrain(y @ p["w_out"], "batch", None, "embed")


def mamba2_apply(cfg, p, x, *, cache: Optional[Dict] = None,
                 emit_cache: bool = False):
    """Pre-norm Mamba2 block with residual.  Train when cache is None;
    one-token decode otherwise: cache = {"conv": (b, K-1, C), "ssd": (b,
    h, ds, hd)}, fp32, written in place (the state carries the position,
    so decode takes none).  ``emit_cache`` (prefill) also returns the
    decode cache of a train-mode pass: the raw pre-conv inputs of the
    last K - 1 positions and the final SSD state, the scan then going
    through the chunked reference (the kernel returns no final state), as
    the reference's prefill does.  Returns (out, cache)."""
    xn = rmsnorm(x, p["norm"])
    zxbcdt = constrain(xn @ p["w_in"], "batch", None, "d_inner")
    z, xbc, dt_raw = _split_in(cfg, zxbcdt)
    if cache is None:
        s, K = x.shape[1], cfg.ssm_conv
        if emit_cache and s < K - 1:
            raise ValueError(
                f"{cfg.name}: a {s}-token prompt is shorter than the conv "
                f"window's K - 1 = {K - 1} raw inputs the decode cache "
                "holds (the reference's prefill emits a short conv state "
                "there, which its decode cannot consume)")
        conv_state = xbc[:, s - (K - 1):].to(F32) if emit_cache else None
        # on a mesh: the conv with every channel on each shard (its
        # weights gathered), the scan over each shard's heads.
        xbc = local_region(_conv_train, (xbc, p["conv_w"], p["conv_b"]),
                           (("batch", None, None), (None, None), (None,)),
                           (0,))
        x_ssm, B, C, dt, A = _scan_inputs(cfg, p, xbc, dt_raw)
        x_ssm = constrain(x_ssm, "batch", None, "ssm_heads", None)
        args = (x_ssm.to(F32).contiguous(), dt.contiguous(), A,
                B.to(F32).contiguous(), C.to(F32).contiguous())
        if not emit_cache:
            y = local_region(
                lambda *a: ops.ssd(*a, chunk=cfg.ssm_chunk,
                                   use_pallas=cfg.use_pallas), args,
                (("batch", None, "ssm_heads", None),
                 ("batch", None, "ssm_heads"), ("ssm_heads",),
                 ("batch", None, None), ("batch", None, None)), (0,))
            return _out(cfg, p, x, y, x_ssm, z), None
        y, ssd_state = ref.ssd_chunked_batch(*args, chunk=cfg.ssm_chunk)
        return _out(cfg, p, x, y, x_ssm, z), {"conv": conv_state,
                                              "ssd": ssd_state}
    # decode: the conv shift register + the O(1) state update, in fp32.
    conv_st, ssd_st = cache["conv"], cache["ssd"]
    window = torch.cat([conv_st.to(F32), xbc.to(F32)], dim=1)   # (b, K, C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(F32))
    xbc1 = F.silu(conv_out + p["conv_b"].to(F32))[:, None]     # (b, 1, C)
    x_ssm, B, C, dt, A = _scan_inputs(cfg, p, xbc1, dt_raw)
    dtA = dt[:, 0] * A                                          # (b, h)
    Sn = (ssd_st.to(F32) * torch.exp(dtA)[..., None, None]
          + torch.einsum("bh,bs,bhd->bhsd", dt[:, 0], B[:, 0], x_ssm[:, 0]))
    y = torch.einsum("bs,bhsd->bhd", C[:, 0], Sn)[:, None]      # (b,1,h,hd)
    conv_st.copy_(window[:, 1:])
    ssd_st.copy_(Sn)
    return _out(cfg, p, x, y, x_ssm, z), cache


def mamba2_cache_decl(cfg, batch: int) -> Dict[str, Decl]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": Decl((batch, cfg.ssm_conv - 1, conv_dim),
                     ("batch", None, "d_inner"), F32, init="zeros"),
        "ssd": Decl((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                    ("batch", "ssm_heads", None, None), F32, init="zeros"),
    }
