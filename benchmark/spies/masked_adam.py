"""Masked Adam's bytes and flops by its definition, at each call that
launches a kernel."""

from benchmark.counts import ops

TARGET = ("unboundednerfpytorch_tpu_torch.ops.cuda.adam", "masked_adam")


def wrap(orig, spies):
    def masked_adam(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad, chunk=None,
                    per_lr=None):
        launches = p.numel() and not (grad is None and skip_zero_grad and per_lr is None)
        if launches:
            with spies.counting():
                spies.add("masked_adam", ops.masked_adam(p, m, v, grad, skip_zero_grad, per_lr))
        return orig(p, m, v, grad, step_size, b1, b2, eps, skip_zero_grad, chunk=chunk,
                    per_lr=per_lr)

    return masked_adam
