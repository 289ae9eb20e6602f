"""Device ms a view in making its rays (render/rays)."""


def read(ctx):
    return ctx.range_ms("render/rays")
