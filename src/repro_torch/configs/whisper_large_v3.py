"""Whisper large-v3 — enc-dec; conv frontend is a STUB: input_specs()
provides precomputed frame embeddings [B, 1500, d_model] [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866, mlp_act="gelu", norm="layernorm",
    is_encoder_decoder=True, n_encoder_layers=32, encoder_len=1500,
    frontend="frames",
)
