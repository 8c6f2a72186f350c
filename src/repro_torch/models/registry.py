"""Model zoo entry points (port of ``models/registry.py``).

``make_batch`` draws the reference's synthetic batches from numpy with
the same ``default_rng(seed)`` draws, so both packages get the same
inputs bit for bit.  The dry-run helpers: ``abstract`` (the parameter
tree without storage), ``input_specs`` (a cell's batch without storage)
and ``num_active_params`` (the 6·N_active·D convention).  ``specs``
gives the parameters' sharding specs on a mesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from . import params as P
from . import transformer as T


def decls(cfg: ModelConfig):
    return T.model_decls(cfg)


def init(cfg: ModelConfig, seed: int = 0, *, device="cuda",
         dtype: Optional[torch.dtype] = None):
    """Random weights from ``seed``, drawn directly on ``device`` (in
    ``dtype`` for every floating leaf when given)."""
    return P.init_params(decls(cfg), seed, device=device, dtype=dtype)


def abstract(cfg: ModelConfig, fake_mode=None):
    """The parameter tree as fake tensors (made in ``fake_mode``) or
    ``meta`` tensors: ``params.abstract_params`` of the decls."""
    return P.abstract_params(decls(cfg), fake_mode)


def specs(cfg: ModelConfig, mesh=None):
    """The parameters' sharding specs on ``mesh`` (a ``DeviceMesh`` or a
    mesh shape): ``params.param_specs`` of the decls."""
    return P.param_specs(decls(cfg), mesh)


def num_params(cfg: ModelConfig) -> int:
    return P.param_count(decls(cfg))


def num_active_params(cfg: ModelConfig) -> int:
    """Active N for MoE (routed experts count only top_k/E of expert
    params) — the 6·N_active·D roofline convention."""
    if not cfg.n_experts:
        return num_params(cfg)
    d = decls(cfg)
    total = P.param_count(d)

    def expert_params(tree):
        n = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                n += expert_params(v)
            elif k in ("w_gate", "w_up", "w_down") and len(v.shape) >= 3 \
                    and v.shape[-3] == cfg.n_experts:
                n += int(np.prod(v.shape))
        return n

    e = expert_params(d)
    return total - e + int(e * cfg.top_k / cfg.n_experts)


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


def input_specs(cfg: ModelConfig, shape: ShapeCfg, fake_mode=None
                ) -> Dict[str, torch.Tensor]:
    """A cell's batch without storage (the reference's ShapeDtypeStruct
    stand-ins): fake CPU tensors made in ``fake_mode``, or ``meta``
    tensors when it is None.  int32 tokens (b, s), (b, s, K) for audio;
    train adds ``labels``; vlm ``patches`` (b, P, vision_dim) bf16 with
    ``s - vision_patches`` text tokens (train, prefill); audio ``cond``
    (b, cond_len, d) bf16; decode one token per row."""
    B, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return P.abstract_tensor(shp, dtype, fake_mode)

    def tok_spec(b, s):
        if cfg.family == "audio":
            return spec((b, s, cfg.n_codebooks), torch.int32)
        return spec((b, s), torch.int32)

    extras: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        extras["cond"] = spec((B, cfg.cond_len, cfg.d_model), torch.bfloat16)
    if shape.kind in ("train", "prefill"):
        s_text = s - cfg.vision_patches if cfg.family == "vlm" else s
        batch = {"tokens": tok_spec(B, s_text)}
        if shape.kind == "train":
            batch["labels"] = tok_spec(B, s_text)
        batch.update(extras)
        if cfg.family == "vlm":
            batch["patches"] = spec((B, cfg.vision_patches, cfg.vision_dim),
                                    torch.bfloat16)
        return batch
    return {"tokens": tok_spec(B, 1), **extras}
