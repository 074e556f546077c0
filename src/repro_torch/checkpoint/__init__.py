"""Checkpoints of the training path (counterpart of ``repro.checkpoint``)."""
