"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, the import guard and the result line.

What runs is the cell's kind (``benchmark/kinds/<kind>.py``, named by its
traffic mix): its ``Unit(cell, seed, device, faults)`` has ``setup()``,
``window(seconds)``, ``run_unit()``, ``spy_settings()``,
``model_flops(totals)``, ``free()``, ``reference(dt)``, ``numbers(ref)``,
``compare(prog, ref)``, ``unit`` (what a unit of work is called) and
``NUMBERS`` (the names of the numbers that decide ``correct``)."""

from __future__ import annotations

import os
import sys
import time

import torch

from benchmark.core import check, guard, spec, trace
from benchmark.core.spies import Spies
from benchmark.counts import peaks


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


class Context:
    """What a per-layer metric's reader reads: the reduced trace, the units
    of work in the traced window, the counts of the spies and the peaks."""

    def __init__(self, tr: trace.Trace, units: int, totals: dict, model_flops: float,
                 unit_s: float):
        self.trace, self.units = tr, units
        self.totals, self.model_flops, self.unit_s = totals, model_flops, unit_s
        self.window_s, self.busy_s = tr.window_s, tr.busy_s

    def range_ms(self, name: str):
        """Device ms per unit of work in ``name``, or None without any."""
        s = self.trace.range_s(name)
        return s / self.units * 1e3 if s > 0 else None

    def roofline(self, op: str):
        """The op's least time over its kernels' time, in %, or None where
        it ran no kernel or was not counted."""
        s = self.trace.op_s(op)
        work = self.totals["ops"].get(op)
        if s <= 0 or not work:
            return None
        return peaks.least_seconds(*work) / s * 100.0

    def idle_share(self):
        """The share of a unit's time on the timed path without the profiler
        (``unit_s``) in which no kernel of the unit ran, in %: the profiler
        and the counters slow the host, not the device, so the traced
        window's own idle share (busy_s over window_s) reads higher."""
        if self.busy_s <= 0:
            return None
        return (1.0 - self.busy_s / self.units / self.unit_s) * 100.0

    def mfu(self):
        """A unit's model FLOPs over its time on the timed path without the
        profiler and the card's f32 peak, in %."""
        if self.busy_s <= 0 or self.model_flops <= 0:
            return None
        return self.model_flops / self.units / self.unit_s / peaks.FLOPS_PER_S["float32"] * 100.0


def run(root, workload: str, seed: int, seconds: float, traced: bool, device,
        overrides: dict | None = None, faults=(), control: bool = False, log=print) -> dict:
    """One run; returns the result dict (its ``checks`` last)."""
    device = torch.device(device)
    cell = spec.load(root, workload)
    if overrides:
        cell.config = spec.merged(cell.config, overrides.get("config", {}))
        cell.traffic = spec.merged(cell.traffic, overrides.get("traffic", {}))
    unit = cell.kind.Unit(cell, seed, device, faults=faults)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    unit.setup()
    setup_s = process_age()
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not traced:
        w = unit.window(seconds)
        result["attempted"], result["failed"] = w["attempted"], w["failed"]
        for m in cell.end_to_end:
            # ``<measure>.<group>``: the kind's measure, in a group of cells
            # whose runs spread alike and so share a bound
            measure = m["name"].split(".", 1)[0]
            if measure in w["metrics"]:
                value, u = w["metrics"][measure]
                result["metrics"][m["name"]] = {"value": value, "unit": u}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        span = float(cell.traffic["trace_seconds"])
        # a unit's time on the timed path without the profiler
        plain = unit.window(span)
        unit_s = plain["seconds"] / plain["attempted"]
        spies = Spies(cell.root, unit.spy_settings())
        with spies.installed():
            tr, n = trace.traced(unit.run_unit, span, device)
        totals = spies.totals()
        ctx = Context(tr, n, totals, unit.model_flops(totals), unit_s)
        log(f"traced {n} {unit.unit} in {tr.window_s:.3f} s ({unit_s * n:.3f} s without the "
            f"profiler); counters {tr.count_s:.4f} s of device time", file=sys.stderr)
        result["attempted"] = n
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0}
    if traced:
        dev["busy_s"], dev["window_s"] = ctx.busy_s, ctx.window_s
    result["device"] = dev
    unit.free()
    t0 = time.perf_counter()
    ref = unit.reference()
    numbers = unit.numbers(ref)
    result["correct"], checks = check.judge(numbers, cell.limits)
    if control:
        low = unit.reference(dt=torch.bfloat16)
        result["control"] = unit.compare(low, ref)
    log(f"reference check: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    result["checks"] = checks
    found = guard.forbidden_modules()
    if found:
        raise guard.ForbiddenImport(found)
    return result
