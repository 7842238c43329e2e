"""Checkpoints of the port's parameter trees (``repro.checkpoint``)."""
