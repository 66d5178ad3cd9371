"""LLaVA-NeXT 34B — anyres patch tiling; frontend is a STUB: input_specs()
provides precomputed patch embeddings [B, 2880, d_model] per assignment."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000, mlp_act="swiglu",
    frontend="patches", num_frontend_tokens=2880,
)
