"""Device ms a step launched in the grids' gather backward (backward/gather, ops/interp.py
GatherTrilerp.backward: the table-sized zero fill, the index_add_, the cast), inside train_step/backward.
"""


def read(ctx):
    return ctx.range_ms("backward/gather")
