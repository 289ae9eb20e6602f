"""The harness: cells, the generators of each traffic kind, the trace, the check."""
