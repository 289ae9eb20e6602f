"""Share of a train step's time (without the profiler) in which no kernel of it ran (%).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.idle_share()
