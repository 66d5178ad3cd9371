"""IBM Granite 3.0 8B — GQA kv=8 [hf:ibm-granite]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155, mlp_act="swiglu",
)
