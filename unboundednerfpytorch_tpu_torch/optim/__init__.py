"""Optimizer: masked Adam and its parameter-group factory."""
