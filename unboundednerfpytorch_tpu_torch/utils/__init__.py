"""Metrics, checkpoints, the reference checkpoint import and the training panels."""
