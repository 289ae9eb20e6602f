"""Device selection for the port's entry points, and the host's waits on it.

The port is written for the GPU. An entry point runs on ``cuda`` unless the
caller asks for the CPU explicitly; without a GPU it raises instead of
falling back, so a CPU run can never pass for a GPU one.

:func:`from_host` and :func:`to_host` are the one place where the timed
paths copy host values to the card or read the card's back. Either copy
waits for the card's queue to drain (a copy from pageable memory, then a
stream synchronisation), so each opens a span, ``sync/h2d`` or
``sync/d2h``, that a trace counts and times (on the CPU too).

:func:`constant` is for host values that stay the same from call to call (a
box, a scene's centre and radius, a grid's shape): the first call copies
them as :func:`from_host` does, and every later one gets the same device
tensor back, with no copy and no wait, under an ``h2d/reused`` span. Every
caller of those values shares that tensor, so no caller writes into it.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.utils.profiling import span

CONSTANTS_KEPT = 256
_constants: collections.OrderedDict = collections.OrderedDict()
_constants_lock = threading.Lock()


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


def constant(values, dtype: torch.dtype | None, device) -> torch.Tensor:
    """:func:`from_host` of values that do not change between calls, made
    once: one device tensor for each set of values (their bits, shape and
    dtype), ``dtype`` and device, of which the last ``CONSTANTS_KEPT`` used
    are kept. The caller must not write into it."""
    a = np.asarray(values)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, dev)
    with _constants_lock:
        t = _constants.get(key)
        if t is not None:
            _constants.move_to_end(key)
    if t is not None:
        with span("h2d/reused"):
            return t
    t = from_host(values, dtype, dev)
    with _constants_lock:
        _constants[key] = t
        if len(_constants) > CONSTANTS_KEPT:
            _constants.popitem(last=False)
    return t


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x.cpu()`` under a ``sync/d2h`` span."""
    with span("sync/d2h"):
        return x.cpu()
