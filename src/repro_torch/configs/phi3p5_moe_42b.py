"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
(hf:microsoft/Phi-3.5-MoE-instruct)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3p5-moe-42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32_064,
    n_experts=16, top_k=2, moe_d_ff=6400,
)
