"""Device ms a step in the benchmark's batch draw (bench/batch): the sampler and the store's index.

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("bench/batch")
