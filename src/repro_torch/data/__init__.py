"""Synthetic training data (`pipeline.TokenPipeline`)."""
