"""Config registry (F1): ``--arch <id>`` resolves here."""
from .base import (ModelConfig, ShapeCfg, SHAPES, LONG_CONTEXT_ARCHS,
                   smoke_variant, MODEL_AXIS)

from . import (mamba2_1p3b, minitron_4b, qwen1p5_32b, gemma3_12b,
               granite_34b, deepseek_v2_lite_16b, phi3p5_moe_42b,
               zamba2_1p2b, paligemma_3b, musicgen_medium)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    mamba2_1p3b, minitron_4b, qwen1p5_32b, gemma3_12b, granite_34b,
    deepseek_v2_lite_16b, phi3p5_moe_42b, zamba2_1p2b, paligemma_3b,
    musicgen_medium)}

# Assignment-spelling aliases (dots normalized).
ALIASES = {
    "mamba2-1.3b": "mamba2-1p3b",
    "qwen1.5-32b": "qwen1p5-32b",
    "phi3.5-moe-42b-a6.6b": "phi3p5-moe-42b",
    "zamba2-1.2b": "zamba2-1p2b",
    "deepseek-v2-lite-16b": "deepseek-v2-lite-16b",
}


def get(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
