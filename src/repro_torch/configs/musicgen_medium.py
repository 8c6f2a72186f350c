"""musicgen-medium [audio] — decoder-only over EnCodec tokens, 4
codebooks, cross-attention to a text-conditioning stub (arXiv:2306.05284)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    n_codebooks=4, cross_attention=True, cond_len=64,
    mlp_gated=False,
)
