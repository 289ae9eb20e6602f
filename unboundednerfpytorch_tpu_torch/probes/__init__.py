"""Measurement entry points of the port."""
