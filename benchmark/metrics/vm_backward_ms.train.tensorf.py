"""Device ms a step in the TensoRF queries' backward (backward/vm, fields/grids.py VMQuery.backward:
the lookups' index_add_ into the planes and lines, the products' and the projection's backward),
inside train_step/backward."""


def read(ctx):
    return ctx.range_ms("backward/vm")
