"""Fault-tolerant checkpoints of training state (``checkpointer``)."""
