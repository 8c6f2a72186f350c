"""Model zoo entry points (port of ``models/registry.py``).

``make_batch`` draws the reference's synthetic batches from numpy with
the same ``default_rng(seed)`` draws, so both packages get the same
inputs bit for bit.  The dry-run helpers (``abstract``, ``specs``,
``input_specs``, ``num_active_params``) wait for the roofline port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import params as P
from . import transformer as T


def decls(cfg: ModelConfig):
    return T.model_decls(cfg)


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda",
         dtype: Optional[torch.dtype] = None):
    """Random weights from ``seed``, drawn directly on ``device`` (in
    ``dtype`` for every floating leaf when given)."""
    return P.init_params(decls(cfg), seed, device=device, dtype=dtype)


def num_params(cfg: ModelConfig) -> int:
    return P.param_count(decls(cfg))


forward = T.forward
cache_decls = T.cache_decls
paged_cache_decls = T.paged_cache_decls
paged_supported = T.paged_supported


def make_batch(cfg: ModelConfig, shape_kind: str, batch: int, seq: int,
               seed: int = 0, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete synthetic batch (smoke tests, examples), the reference's
    draws in its order: int32 tokens (b, s) — (b, s, K) for audio —
    uniform over the logical vocab, ``labels`` likewise for
    ``shape_kind == "train"``; vlm ``patches`` (b, P, vision_dim) and
    audio ``cond`` (b, cond_len, d) as N(0, 1) rounded to bf16.  For vlm,
    ``seq`` counts the patches: the text gets ``seq - vision_patches``
    tokens.  Decode batches hold one token per row."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size

    def toks(b, s):
        shape = (b, s, cfg.n_codebooks) if cfg.family == "audio" else (b, s)
        return torch.from_numpy(
            rng.integers(0, V, shape).astype(np.int32)).to(device)

    def normal_bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device).to(torch.bfloat16)

    out: Dict[str, torch.Tensor] = {}
    s_text = seq - cfg.vision_patches if cfg.family == "vlm" else seq
    out["tokens"] = toks(batch, 1 if shape_kind == "decode" else s_text)
    if shape_kind == "train":
        out["labels"] = toks(batch, s_text)
    if cfg.family == "vlm" and shape_kind != "decode":
        out["patches"] = normal_bf16(
            (batch, cfg.vision_patches, cfg.vision_dim))
    if cfg.family == "audio":
        out["cond"] = normal_bf16((batch, cfg.cond_len, cfg.d_model))
    return out
