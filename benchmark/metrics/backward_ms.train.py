"""Device ms a step launched while the backward ran (train_step/backward): autograd's kernels."""


def read(ctx):
    return ctx.range_ms("train_step/backward")
