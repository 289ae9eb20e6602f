"""The work of each of the port's hand-written kernels by the definition of
its op, and the least time the card could take for it.

Each function takes what the timed path handed the op and returns (bytes,
flops) as device scalars, counted from the op's definition whatever
implements it: each input byte that the result needs is read once, each
output byte written once. Where the work depends on the data, these inputs'
needs are counted: the march reads a ray's samples up to its early exit, the
backward scan the samples that the forward processed, masked Adam the
parameters, moments and updates only where the gradient is not 0. The
floating-point operations are counted per element as written in each
function; every one of these ops is bound by its bytes on the card by a wide
margin (at most a few flops a byte against a ridge near 20).
"""

from __future__ import annotations

import torch

EARLY_EXIT_T = 1e-3
# flops per element of each op's arithmetic
MARCH_FORWARD_FLOPS = 10  # add shift, softplus (exp, log1p, max), scale, exp, 1 - a, T a, T (1 - a)
MARCH_BACKWARD_FLOPS = 20  # the reverse suffix sum, the alpha derivative and the chain rule
TV_FLOPS = 18  # three axes: two differences, two clamps, a weighted sum
ADAM_FLOPS = 12  # two moment updates, a square root, a division, the step and its rounding
CUMDIST_FLOPS = 2  # the running sum and its comparison


def _t_excl(alpha: torch.Tensor) -> torch.Tensor:
    t = torch.cumprod(1.0 - alpha, dim=-1)
    return torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=-1)


def march_forward(density, mask, alpha, residuals: bool):
    """``unerf_kernels::march_forward``: a ray's mask is read up to its early
    exit and its density where the mask is on; weights and alpha [N, S] are
    written (and t_excl with ``residuals``), and alphainv_last [N]."""
    N, S = density.shape
    processed = _t_excl(alpha) >= EARLY_EXIT_T
    live = (processed & mask).sum()
    out = N * S * density.element_size() * (3 if residuals else 2) + N * density.element_size()
    nbytes = processed.sum() * mask.element_size() + live * density.element_size() + out
    return nbytes, live * MARCH_FORWARD_FLOPS


def march_backward(alpha, t_excl, gw, density, mask):
    """``unerf_kernels::march_backward``: for each processed sample t_excl and
    the mask, and where the mask is on alpha, the weights' cotangent and the
    density; per ray alphainv and its cotangent; the density's gradient
    [N, S] written."""
    N, S = density.shape
    processed = t_excl >= EARLY_EXIT_T
    live = (processed & mask).sum()
    es = density.element_size()
    nbytes = (processed.sum() * (es + mask.element_size()) + live * 3 * es + N * 2 * es
              + N * S * es)
    return nbytes, live * MARCH_BACKWARD_FLOPS


def tv_add_grad(param, grad, dense: bool):
    """``unerf_kernels::tv_add_grad``: dense, the grid and its gradient read
    and the new gradient written whole; otherwise only where the gradient is
    not 0."""
    n = param.numel()
    per = param.element_size() + 2 * grad.element_size()
    if dense:
        return torch.tensor(n * per, device=param.device), torch.tensor(n * TV_FLOPS,
                                                                         device=param.device)
    nz = torch.count_nonzero(grad)
    return n * grad.element_size() + nz * (param.element_size() + grad.element_size()), \
        nz * TV_FLOPS


def masked_adam(p, m, v, grad, skip_zero_grad: bool, per_lr):
    """``unerf_kernels::masked_adam``: the gradient read whole; where it is
    not 0 (or everywhere, without the skip or with a per-element lr) the
    parameter and both moments read and written, and the lr read."""
    n = p.numel()
    if grad is not None and skip_zero_grad and per_lr is None:
        upd = torch.count_nonzero(grad)
    else:
        upd = torch.tensor(n, device=p.device)
    nbytes = upd * 2 * (p.element_size() + m.element_size() + v.element_size())
    if grad is not None:
        nbytes = nbytes + n * grad.element_size()
    if per_lr is not None:
        nbytes = nbytes + n * per_lr.element_size()
    return nbytes, upd * ADAM_FLOPS


def cumdist_thres(dist):
    """``unerf_kernels::cumdist_thres``: the distances read, one flag a
    sample written."""
    n = dist.numel()
    return (torch.tensor(n * (dist.element_size() + 1), device=dist.device),
            torch.tensor(n * CUMDIST_FLOPS, device=dist.device))
