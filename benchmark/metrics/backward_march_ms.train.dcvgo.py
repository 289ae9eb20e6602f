"""Device ms a step launched in the march's backward (backward/march, ops/cuda/march.py
FusedMarch.backward: the reverse scan and the alpha term), inside train_step/backward.

The DCVGO cells' copy: it moves their own rate, which has a bound of its own.
"""


def read(ctx):
    return ctx.range_ms("backward/march")
