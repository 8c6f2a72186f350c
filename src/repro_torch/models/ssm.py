"""Mamba2 parameter declarations (port of ``models/ssm.py``, decls only).

The SSD scan and the mamba2 block (kernel B6) come with the ssm slice;
the declarations are here so every architecture's parameter tree can be
built and counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .params import Decl


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
