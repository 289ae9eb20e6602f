"""Device ms a step in the TensoRF fields' queries (field/vm, fields/grids.py TensoRFGrid.forward: the
six plane and line lookups of each field, the products and f_vec's projection), inside
train_step/forward_loss."""


def read(ctx):
    return ctx.range_ms("field/vm")
