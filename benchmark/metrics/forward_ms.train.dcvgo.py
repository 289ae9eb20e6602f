"""Device ms a step in the forward and the losses (train_step/forward_loss).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("train_step/forward_loss")
