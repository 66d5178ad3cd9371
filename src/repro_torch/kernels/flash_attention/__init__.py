"""Causal / windowed GQA flash attention over a full sequence, forward and
gradient: `ops.flash_attention` (model layout) and `ops.flash_attention_cuda`
(the kernels, forced)."""
