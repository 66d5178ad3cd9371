"""Model configurations: `base.ModelConfig` and one module per architecture
(`CONFIG`), copies of the JAX package's data files."""
