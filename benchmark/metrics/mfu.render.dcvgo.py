"""A view's model FLOPs over its time without the profiler and the card's f32 peak (%).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.mfu()
