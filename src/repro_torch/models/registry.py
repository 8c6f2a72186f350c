"""Model zoo entry points (port of ``models/registry.py``)."""

from __future__ import annotations

from typing import Optional

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
