"""Device selection for the port's entry points, and the host's waits on it.

The port is written for the GPU. An entry point runs on ``cuda`` unless the
caller asks for the CPU explicitly; without a GPU it raises instead of
falling back, so a CPU run can never pass for a GPU one.

:func:`from_host` and :func:`to_host` are the one place where the timed
paths copy host values to the card or read the card's back. Either copy
waits for the card's queue to drain (a copy from pageable memory, then a
stream synchronisation), so each opens a span, ``sync/h2d`` or
``sync/d2h``, that a trace counts and times (on the CPU too).
"""

from __future__ import annotations

import time

import torch

from unboundednerfpytorch_tpu_torch.utils.profiling import span


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


def from_host(values, dtype: torch.dtype | None, device) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)`` of host
    values (a tuple, a list, a numpy array) under a ``sync/h2d`` span."""
    with span("sync/h2d"):
        return torch.as_tensor(values, dtype=dtype, device=device)


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x.cpu()`` under a ``sync/d2h`` span."""
    with span("sync/d2h"):
        return x.cpu()
