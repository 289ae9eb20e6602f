"""Device ms a step in masked Adam (train_step/adam)."""


def read(ctx):
    return ctx.range_ms("train_step/adam")
