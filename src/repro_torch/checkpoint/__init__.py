"""Checkpointing of the port (port of ``repro.checkpoint``)."""
