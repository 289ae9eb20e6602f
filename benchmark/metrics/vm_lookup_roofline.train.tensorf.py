"""The VM lookup's least time on the card over its device time under field/vm (%): bytes and flops by
the lookup's definition at the timed inputs (counts/vm.py, counted by spies/vm_lookup.py), whatever
kernels do it."""

from benchmark.counts import peaks


def read(ctx):
    s = ctx.trace.range_s("field/vm")
    work = ctx.totals["ops"].get("vm_lookup")
    if s <= 0 or not work:
        return None
    return peaks.least_seconds(*work) / s * 100.0
