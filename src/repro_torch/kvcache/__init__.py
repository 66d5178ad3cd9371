"""The F2-tiered paged KV cache of the serving engine (`paged`)."""
