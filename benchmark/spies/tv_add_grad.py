"""The TV injection's bytes and flops by its definition, at each call (where
the train step calls it)."""

from benchmark.counts import ops

TARGET = ("unboundednerfpytorch_tpu_torch.train.step", "tv_add_grad")


def wrap(orig, spies):
    def tv_add_grad(param, grad, wx, wy, wz, gate, dense, out=None, lo=None, hi=None):
        with spies.counting():
            spies.add("tv_add_grad", ops.tv_add_grad(param, grad, bool(dense)))
        return orig(param, grad, wx, wy, wz, gate, dense, out=out, lo=lo, hi=hi)

    return tv_add_grad
