"""Gemma 3 27B — 5:1 local:global sliding window, qk-norm, 128k context."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144, mlp_act="geglu", qk_norm=True,
    sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
)
