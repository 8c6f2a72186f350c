"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block
(arXiv:2411.15242)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1p2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    shared_attn_every=6,
)
