"""The RWKV-6 WKV recurrence, forward and gradient: `ops.wkv` (model
layout, differentiable) and `ops.wkv_cuda` (the kernels, forced)."""
