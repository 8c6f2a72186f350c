"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 +
2 shared experts, first layer dense (arXiv:2405.04434).  The assignment
line's "160 routed" is the full-V2 config; V2-Lite has 64 (DESIGN §8)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=10_944, vocab_size=102_400,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
)
