"""The model stack: `registry` (arch id -> ModelConfig), `layers` (the
decode-path functions) and `transformer` (the dense family as
`nn.Module`s, with `init_params`, `init_cache` and `decode_step`)."""
