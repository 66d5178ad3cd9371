"""Hymba 1.5B — parallel attention + SSM heads per layer, ssm_state=16,
3 full-attention layers (first/mid/last), rest sliding-window
[arXiv:2411.13676]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, mlp_act="swiglu",
    ssm_state=16, ssm_expand=2, sliding_window=1024, n_global_attn_layers=3,
)
