"""Device selection for the port's entry points.

The port is written for the GPU. An entry point runs on ``cuda`` unless the
caller asks for the CPU explicitly; without a GPU it raises instead of
falling back, so a CPU run can never pass for a GPU one.
"""

from __future__ import annotations

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
