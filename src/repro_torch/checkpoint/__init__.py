"""Checkpoints on disk (`checkpointer.Checkpointer`)."""
