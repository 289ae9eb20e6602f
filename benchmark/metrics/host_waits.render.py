"""The host's waits on the card a view: the port's ``sync/h2d`` and ``sync/d2h`` spans (device.py's
from_host and to_host), each a copy that drains the card's queue first.
"""


def read(ctx):
    n = sum(len(iv.starts) for name, iv in ctx.trace.ranges.items() if name.startswith("sync/"))
    return n / ctx.units if n else None
