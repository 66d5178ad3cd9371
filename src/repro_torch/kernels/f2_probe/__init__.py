"""The F2 probe and write kernels: `fused_probe` and `fused_write`."""
