"""Total-variation gradient (plain PyTorch).

Counterpart of ``unboundednerfpytorch_tpu/ops/tv.py``: a clamped (+-1)
6-neighbour TV gradient that the train step adds to the parameter gradient
between backward and the optimizer (TV is never part of the loss value).
Weights are divided by 6 inside the op; missing neighbours contribute 0;
``dense_mode=False`` only touches voxels whose existing grad is nonzero.

Grids are channel-last ``[..., X, Y, Z, C]``; leading (bank) axes are
independent. The per-axis terms are accumulated in place so that a
full-width grid needs a few grid-sized temporaries, not one per shift.
:func:`tensorf_tv_grads` is the TV of a TensoRF grid, a smooth-L1 loss over
its planes and vectors whose gradient the step adds the same way.
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


def _smooth_l1_sum(d: torch.Tensor) -> torch.Tensor:
    a = d.abs()
    return torch.where(a < 1.0, 0.5 * d * d, a - 0.5).sum()


def tensorf_tv_loss(leaves: dict, wx: float, wy: float, wz: float) -> torch.Tensor:
    """The JAX package's smooth-L1 TV of a TensoRF grid (``train/step.py::
    _tensorf_tv_loss``): differences of neighbours along each axis of the
    planes and vectors, each axis weighed by its own weight, over 6."""
    sl1 = _smooth_l1_sum
    xy, xz, yz = leaves["xy_plane"], leaves["xz_plane"], leaves["yz_plane"]
    loss = (wx * sl1(xy[1:] - xy[:-1]) + wy * sl1(xy[:, 1:] - xy[:, :-1])
            + wx * sl1(xz[1:] - xz[:-1]) + wz * sl1(xz[:, 1:] - xz[:, :-1])
            + wy * sl1(yz[1:] - yz[:-1]) + wz * sl1(yz[:, 1:] - yz[:, :-1])
            + wx * sl1(leaves["x_vec"][1:] - leaves["x_vec"][:-1])
            + wy * sl1(leaves["y_vec"][1:] - leaves["y_vec"][:-1])
            + wz * sl1(leaves["z_vec"][1:] - leaves["z_vec"][:-1]))
    return loss / 6.0


def tensorf_tv_grads(leaves: dict, wx: float, wy: float, wz: float) -> dict:
    """name -> the gradient of :func:`tensorf_tv_loss` for each plane and
    vector of ``leaves`` (``f_vec`` takes no part), by autograd on detached
    copies. A loss's gradient, not a kernel: TensoRF's TV is no Pallas site
    in the JAX package."""
    names = [k for k in leaves if k != "f_vec"]
    with torch.enable_grad():
        copies = {k: leaves[k].detach().requires_grad_(True) for k in names}
        grads = torch.autograd.grad(tensorf_tv_loss(copies, wx, wy, wz),
                                    [copies[k] for k in names])
    return dict(zip(names, grads))
