"""Timing on the card and the roofline bound, shared by the probes and
``chip_smoke.py``.

Two times are kept apart. The **call** time puts one pair of CUDA events
around one call of a Python wrapper: for a kernel of tens of microseconds it
is mostly the host's dispatch (output allocation, the ``torch.library`` op).
The **device** time of a launch captures ``launches`` calls into one CUDA
graph, replays it between one pair of events and divides by the count: the
device then runs the launches back to back, whatever the host's pace. The
same method on an empty kernel gives the **launch floor**, the least time
any launch takes; a kernel whose roofline bound lies under the floor is
judged against the floor.
"""

from __future__ import annotations

import ctypes
import statistics

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# a call under this many ms is timed again by the many-launch method
SHORT_KERNEL_MS = 0.2
MANY_LAUNCHES = 50


def time_ms(fn, iters: int = 20, warmup: int = 3, launches: int = 1) -> float:
    """Median time of one ``fn()`` in ms. ``launches=1``: CUDA events around
    each call (the time of a call through the wrapper). ``launches=n``: n
    calls captured into a CUDA graph, events around each replay, over n (the
    device time of a launch; ``fn`` must not synchronise)."""
    for _ in range(warmup):
        fn()
    run = fn
    if launches > 1:
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        run = graph.replay
        run()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / launches



def cold_ms(fn, iters: int = 20) -> float:
    """Device ms of ``fn`` (one launch) with the 50 MB L2 cache flushed
    before each call, as the train step leaves it for its one update of a
    grid: CUDA events around each call just after a 256 MB fill, the mean
    over ``iters`` after a warm-up. A spin of about a millisecond between
    the fill and the first event keeps the card busy while the host makes
    the call, so the events time the kernel and not the host's launch."""
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    total = 0.0
    for i in range(iters + 2):
        flush.fill_(float(i))
        torch.cuda._sleep(2_000_000)  # cycles: about 1 ms at the H100's clock
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= 2:
            total += start.elapsed_time(end)
    del flush
    return total / iters

def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms a launch, ms a call through the wrapper) of ``fn``. They
    are one measurement for a call of ``SHORT_KERNEL_MS`` or more; a shorter
    one is timed again by the many-launch method."""
    call = time_ms(fn, iters, warmup)
    if call >= SHORT_KERNEL_MS:
        return call, call
    return time_ms(fn, iters, warmup, launches=MANY_LAUNCHES), call


def launch_floor_ms() -> float:
    """Device time of an empty ``<<<1, 32>>>`` kernel (``csrc/march.cu::
    launch_floor``) by the many-launch method: what any launch costs."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    lib = build.load("march")
    fn = lib.launch_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]

    def launch():
        build.check(lib, fn(torch.cuda.current_stream().cuda_stream), "launch_floor")

    return time_ms(launch, launches=MANY_LAUNCHES)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the f32 rate, and which of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
