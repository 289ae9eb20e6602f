"""The march backward's least time on the card over its kernels' time (%)."""


def read(ctx):
    return ctx.roofline("march_backward")
