"""The march backward's bytes and flops by its definition, at each call."""

from benchmark.core.spies import alpha_of
from benchmark.counts import ops

TARGET = ("unboundednerfpytorch_tpu_torch.ops.cuda.march", "march_backward")


def wrap(orig, spies):
    def march_backward(alpha, t_excl, alphainv, gw, gl, shift, interval, density, mask):
        out = orig(alpha, t_excl, alphainv, gw, gl, shift, interval, density, mask)
        with spies.counting():
            a = alpha_of(density, mask, shift, interval)
            spies.add("march_backward", ops.march_backward(a, ops._t_excl(a), gw, density, mask))
        return out

    return march_backward
