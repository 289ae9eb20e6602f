"""Device ms a step in the forward and the losses (train_step/forward_loss)."""


def read(ctx):
    return ctx.range_ms("train_step/forward_loss")
