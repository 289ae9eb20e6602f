"""Total-variation gradient (plain PyTorch).

Counterpart of ``unboundednerfpytorch_tpu/ops/tv.py``: a clamped (+-1)
6-neighbour TV gradient that the train step adds to the parameter gradient
between backward and the optimizer (TV is never part of the loss value).
Weights are divided by 6 inside the op; missing neighbours contribute 0;
``dense_mode=False`` only touches voxels whose existing grad is nonzero.

Grids are channel-last ``[..., X, Y, Z, C]``; leading (bank) axes are
independent. The per-axis terms are accumulated in place so that a
full-width grid needs a few grid-sized temporaries, not one per shift.
"""

from __future__ import annotations

import torch


def _add_axis_tv_grad(acc: torch.Tensor, param: torch.Tensor, axis: int, w: float) -> None:
    """acc += w * (clamp(p_i - p_{i+1}) + clamp(p_i - p_{i-1})) along ``axis``."""
    n = param.shape[axis]
    if n < 2:
        return
    diff = (param.narrow(axis, 0, n - 1) - param.narrow(axis, 1, n - 1)).clamp_(-1.0, 1.0)
    term = torch.zeros_like(param)
    term.narrow(axis, 0, n - 1).copy_(diff)
    term.narrow(axis, 1, n - 1).sub_(diff)
    del diff
    acc.add_(term.mul_(w))


def total_variation_grad(
    param: torch.Tensor,
    wx: float,
    wy: float,
    wz: float,
    dense_mode: bool,
    existing_grad: torch.Tensor | None = None,
) -> torch.Tensor:
    """TV gradient of ``param`` [..., X, Y, Z, C] in the param's dtype."""
    nd = param.ndim
    acc = torch.zeros_like(param)
    for axis, w in ((nd - 4, wx), (nd - 3, wy), (nd - 2, wz)):
        _add_axis_tv_grad(acc, param, axis, w / 6.0)
    if not dense_mode:
        if existing_grad is None:
            raise ValueError("dense_mode=False requires the existing grad")
        acc = torch.where(existing_grad != 0, acc, torch.zeros_like(acc))
    return acc
