"""Device ms a step launched in the march's backward (backward/march, ops/cuda/march.py
FusedMarch.backward: the reverse scan and the alpha term), inside train_step/backward.
"""


def read(ctx):
    return ctx.range_ms("backward/march")
