"""A view's model FLOPs over its time without the profiler and the card's f32 peak (%)."""


def read(ctx):
    return ctx.mfu()
