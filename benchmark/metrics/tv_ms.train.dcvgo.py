"""Device ms a step in the TV injection (train_step/tv).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("train_step/tv")
