"""GLM-4 9B — GQA kv=2, partial rotary [hf:THUDM/glm-4-9b]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552, mlp_act="swiglu", rope_fraction=0.5,
)
