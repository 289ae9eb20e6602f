"""The march forward's bytes and flops by its definition, at each call."""

from benchmark.core.spies import alpha_of
from benchmark.counts import ops

TARGET = ("unboundednerfpytorch_tpu_torch.ops.cuda.march", "march_forward")


def wrap(orig, spies):
    def march_forward(density, mask, shift, interval, residuals=True):
        out = orig(density, mask, shift, interval, residuals)
        with spies.counting():
            spies.add("march_forward", ops.march_forward(
                density, mask, alpha_of(density, mask, shift, interval), residuals))
        return out

    return march_forward
