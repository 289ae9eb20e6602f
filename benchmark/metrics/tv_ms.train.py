"""Device ms a step in the TV injection (train_step/tv)."""


def read(ctx):
    return ctx.range_ms("train_step/tv")
