"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1p3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
)
