"""Tracing and timing: a ``torch.profiler`` trace around any region, a
per-step wall-clock aggregator with percentiles, and a rays/s meter.

The port's counterpart of ``unboundednerfpytorch_tpu/utils/profiling.py``.
:func:`trace` records the host's operations and, on the card, its kernels
(CUPTI), and writes a Chrome trace (``chrome://tracing``, Perfetto) into
``log_dir``. It yields the profiler, so that the caller reads
``key_averages()`` afterwards; the JAX one yields nothing. The step's phases
run under ``record_function`` ranges (``train_step/*``, ``forward/*``,
``render/*``); the hand-written kernels launch inside ``torch.library`` ops,
so their device time is credited to the range around the op, and a train
step's backward, which runs on autograd's thread, lies outside the step's
ranges. :class:`StepTimer` and :class:`RaysPerSecond` are the JAX package's,
with the same summaries for the same clock readings.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed region: the host's operations and, on the card,
    its kernels. ``device``: None -> ``cuda`` (raises without a GPU);
    ``"cpu"`` records the host alone. Yields the ``torch.profiler.profile``;
    on leaving, its Chrome trace is written to ``<log_dir>/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unboundednerfpytorch_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Per-step wall-clock aggregator with percentile summaries; call
    ``tick`` at blocking step boundaries. The first ``warmup`` intervals
    are not kept."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "steps_per_s": float(1.0 / arr.mean()),
            "n": len(arr),
        }


class RaysPerSecond:
    """Throughput meter: accumulate (n_rays, seconds) pairs."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def add(self, n_rays: int, seconds: float) -> None:
        self.rays += n_rays
        self.seconds += seconds

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0
