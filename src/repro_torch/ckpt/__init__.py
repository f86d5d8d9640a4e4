"""Fault-tolerant checkpointing of tensor trees (``checkpoint``)."""
