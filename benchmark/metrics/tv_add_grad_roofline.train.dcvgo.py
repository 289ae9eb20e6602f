"""TV's least time on the card over its kernels' time (%).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.roofline("tv_add_grad")
