"""The serving engine: continuous batching over the paged or the
contiguous KV cache (`engine`)."""
