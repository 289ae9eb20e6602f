"""Device ms a step in masked Adam (train_step/adam).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("train_step/adam")
