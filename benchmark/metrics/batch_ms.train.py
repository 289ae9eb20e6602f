"""Device ms a step in the benchmark's batch draw (bench/batch): the sampler and the store's index."""


def read(ctx):
    return ctx.range_ms("bench/batch")
