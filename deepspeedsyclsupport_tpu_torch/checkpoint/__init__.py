"""Checkpointing of the port: the native single-process format."""
