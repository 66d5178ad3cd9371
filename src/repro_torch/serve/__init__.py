"""Serving: the engine's continuous batching over the paged or the
contiguous KV cache (`engine`), the prefill/decode steps and the F2 KV
service (`serve_step`), and the ticketed session layer (`sessions`)."""
