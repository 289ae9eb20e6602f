"""Share of a view's time (without the profiler) in which no kernel of it ran (%)."""


def read(ctx):
    return ctx.idle_share()
