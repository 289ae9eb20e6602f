"""Device ms a view in the cached forward of its chunks (render/chunk).

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("render/chunk")
