"""Device ms a view in making its rays (render/rays).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("render/rays")
