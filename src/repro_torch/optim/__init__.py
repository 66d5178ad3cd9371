"""Optimizers: AdamW (`adamw`)."""
