"""Kimi K2 — trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2; paper-table].  Note (DESIGN.md SArch-applicability): the
published model has one leading dense layer; we model all 61 layers as MoE
(+shared expert), a <0.1% param-count deviation, to keep the scanned stack
homogeneous for O(1)-depth HLO."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
)
