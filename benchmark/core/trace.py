"""The traced window: a ``torch.profiler`` trace of the timed path, reduced
to what the per-layer metrics read.

Device time is attributed by where its work was launched. A kernel belongs
to a ``record_function`` range (``train_step/forward_loss``,
``render/chunk``, the benchmark's ``bench/batch``, ...) when the host call
that launched it ran while the range was open, on any thread: the
backward's kernels are launched by autograd's own thread while the step's
``train_step/backward`` range is open. It belongs to one of the port's ops
(``unerf_kernels::<op>``) when that op launched it, on its thread. Kernels
launched under ``bench/count`` (the benchmark's own counters, see
``spies``) belong to nothing and are left out of the busy time
(``count_s`` holds their device seconds).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COUNT_RANGE = "bench/count"
WINDOW_RANGE = "bench/window"


class Intervals:
    """Sorted, non-overlapping [start, end) intervals of one name (and
    thread) and a containment test."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [a for a, _ in spans]
        self.ends = [b for _, b in spans]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def _outermost(spans):
    """Nested spans of one name merged into their outermost ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


class Trace:
    """The reduced trace (times in seconds)."""

    def __init__(self, events: list):
        X = [e for e in events if e.get("ph") == "X"]
        ranges = collections.defaultdict(list)
        ops = collections.defaultdict(list)  # (op, tid) -> spans
        launches = {}
        host = collections.defaultdict(list)  # tid -> (start, end, name)
        device = []
        for e in X:
            cat, ts, dur = e.get("cat", ""), float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, e.get("name", ""), args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launches[args["correlation"]] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                ranges[e["name"]].append((ts, ts + dur))
                host[e.get("tid")].append((ts, ts + dur, e["name"]))
            elif cat == "cpu_op":
                host[e.get("tid")].append((ts, ts + dur, e["name"]))
                if e["name"].startswith("unerf_kernels::"):
                    ops[(e["name"].split("::", 1)[1], e.get("tid"))].append((ts, ts + dur))
        win = ranges.get(WINDOW_RANGE) or [(min((d[0] for d in device), default=0.0),
                                            max((d[1] for d in device), default=0.0))]
        self.w0, self.w1 = win[0]
        self.window_s = self.w1 - self.w0
        self.ranges = {k: Intervals(_outermost(v)) for k, v in ranges.items()}
        self.ops = {k: Intervals(_outermost(v)) for k, v in ops.items()}
        count = self.ranges.get(COUNT_RANGE)
        self.kernels = []  # (start, end, name, launch tid, launch time)
        counters = []
        for a, b, name, corr in device:
            tid, t = launches.get(corr, (None, a))
            if b <= self.w0 or a >= self.w1:
                continue
            span = (max(a, self.w0), min(b, self.w1), name, tid, t)
            (counters if count is not None and count.contains(t) else self.kernels).append(span)
        self.count_s = sum(b - a for a, b in _merge(counters))
        main = None
        for tid, spans in host.items():
            if any(n == WINDOW_RANGE for _, _, n in spans):
                main = tid
        self.host = sorted(host.get(main, []))
        self.busy_s = sum(b - a for a, b in _merge(self.kernels))

    def range_s(self, name: str) -> float:
        """Device seconds of the kernels launched while a range of ``name``
        was open (0 where the trace has no such range)."""
        iv = self.ranges.get(name)
        if iv is None:
            return 0.0
        return sum(b - a for a, b, _, _, t in self.kernels if iv.contains(t))

    def op_s(self, op: str) -> float:
        """Device seconds of the kernels that ``unerf_kernels::<op>`` launched."""
        total = 0.0
        for (name, tid), iv in self.ops.items():
            if name == op:
                total += sum(b - a for a, b, _, ktid, t in self.kernels
                             if ktid == tid and iv.contains(t))
        return total

    def device_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for a, b, name, _, _ in self.kernels:
            by[name] += b - a
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window by what the host's main
        thread was in (its innermost range or op) when each gap began."""
        by = collections.Counter()
        spans = [s for s in self.host if s[2] != WINDOW_RANGE]
        stack, i, t = [], 0, self.w0
        for a, b in _merge(self.kernels) + [[self.w1, self.w1]]:
            if a > t:
                # the spans open at t, innermost last (one thread's nest)
                while i < len(spans) and spans[i][0] <= t:
                    while stack and stack[-1][1] < spans[i][0]:
                        stack.pop()  # ended before this one began
                    stack.append(spans[i])
                    i += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                by[stack[-1][2] if stack else "host: outside any range"] += a - t
            t = max(t, b)
        return [[k, v] for k, v in by.most_common(n)]


def _merge(spans):
    out = []
    for a, b, *_ in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def traced(run_unit, min_seconds: float, device: torch.device):
    """Run ``run_unit`` under the profiler until ``min_seconds`` have passed
    (at least once), the window ending when the device has finished.
    Returns (Trace, units run)."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = 0
    with profile(activities=acts) as prof:
        with record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            while True:
                run_unit()
                n += 1
                if time.perf_counter() - t0 >= min_seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events), n
