"""Checkpointing of the port: the single-process native format, tag
history and the synchronous and async checkpoint engines."""
