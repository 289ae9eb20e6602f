"""Device selection for the port's entry points.

The port is written for the GPU. An entry point runs on ``cuda`` unless the
caller asks for the CPU explicitly; without a GPU it raises instead of
falling back, so a CPU run can never pass for a GPU one.
"""

from __future__ import annotations

import time

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA request without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def seconds_since(since: float, device: torch.device) -> float:
    """Host seconds since ``since`` (a ``time.perf_counter()`` reading), once
    a CUDA ``device`` has finished what was queued on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - since
