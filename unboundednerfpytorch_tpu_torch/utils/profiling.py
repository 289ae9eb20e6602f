"""Tracing: the port's spans, and a ``torch.profiler`` trace around any region.

The port's counterpart of ``unboundednerfpytorch_tpu/utils/profiling.py``.
:func:`span` is the one way the port opens a span: a
``torch.profiler.record_function`` range while a profiler records, so that
every span lies on the clock of the device trace, and a shared null context
otherwise, which costs one flag check and no dispatcher call. The step's
phases run under ``train_step/*`` spans, the forwards' under ``forward/*``,
a view's under ``render/*``; the host's waits on the card under ``sync/h2d``
and ``sync/d2h`` (:mod:`..device`); the grids' gather backward and the
march's under ``backward/gather`` and ``backward/march``; a TensoRF field's
query under ``field/vm`` and its backward under ``backward/vm``. The hand-written
kernels launch inside ``torch.library`` ops, so their device time is
credited to the span around the op. A train step's backward runs on
autograd's thread while the main thread waits in ``train_step/backward``:
its kernels are credited by launch time to ``train_step/backward``, and
within it to the ``backward/*`` span they were launched in.

:func:`trace` records the host's operations and, on the card, its kernels
(CUPTI), and writes a Chrome trace (``chrome://tracing``, Perfetto) into
``log_dir``. It yields the profiler, so that the caller reads
``key_averages()`` afterwards; the JAX one yields nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared null context."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed region: the host's operations and, on the card,
    its kernels. ``device``: None -> ``cuda`` (raises without a GPU);
    ``"cpu"`` records the host alone. Yields the ``torch.profiler.profile``;
    on leaving, its Chrome trace is written to ``<log_dir>/trace.json``."""
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
