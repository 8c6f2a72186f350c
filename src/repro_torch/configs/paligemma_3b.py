"""paligemma-3b [vlm] — SigLIP stub (precomputed patch embeddings) +
gemma backbone, MQA kv=1 (arXiv:2407.07726)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16_384, vocab_size=257_216,
    vision_patches=256, vision_dim=1152,
)
