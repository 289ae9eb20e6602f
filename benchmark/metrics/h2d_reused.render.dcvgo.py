"""The host constants a view reused with no copy: the port's ``h2d/reused`` spans (device.py's
constant), each a device tensor made once and handed back instead of a ``sync/h2d`` copy.

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    iv = ctx.trace.ranges.get("h2d/reused")
    return len(iv.starts) / ctx.units if iv is not None else None
