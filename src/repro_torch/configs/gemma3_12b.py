"""gemma3-12b [dense] — 5:1 local:global sliding-window, 128k-class
(hf:google/gemma-3-12b family).  head_dim 256 per published config
(3840/16 = 240 is not lane-aligned; see DESIGN §8)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15_360, vocab_size=262_144,
    sliding_window=1024, local_global_pattern=5,
    rope_theta=1e4, rope_theta_global=1e6, qk_norm=True,
)
