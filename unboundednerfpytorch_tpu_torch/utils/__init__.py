"""Metrics and checkpoints."""
