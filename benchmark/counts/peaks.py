"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W), and the least time of
an amount of work on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}


def least_seconds(nbytes: float, flops: float, precision: str = "float32") -> float:
    """The larger of the bytes over the memory's rate and the operations
    over the rate of ``precision``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[precision])
