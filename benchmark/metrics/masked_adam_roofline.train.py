"""Masked Adam's least time on the card over its kernels' time (%)."""


def read(ctx):
    return ctx.roofline("masked_adam")
