"""Device ms a step launched while the backward ran (train_step/backward): autograd's kernels.

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("train_step/backward")
