"""Device ms a view in the cached forward of its chunks (render/chunk)."""


def read(ctx):
    return ctx.range_ms("render/chunk")
