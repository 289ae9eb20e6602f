"""Host ms a view inside the port's ``sync/h2d`` and ``sync/d2h`` spans: the wait for the card's queue to
drain, then the small copy (device.py's from_host and to_host).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    s = sum(b - a for name, iv in ctx.trace.ranges.items() if name.startswith("sync/")
            for a, b in zip(iv.starts, iv.ends))
    return s / ctx.units * 1e3 if s > 0 else None
