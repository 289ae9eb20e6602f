"""The march forward's least time on the card over its kernels' time, in a render (%)."""


def read(ctx):
    return ctx.roofline("march_forward")
