"""Density -> alpha activation and the transmittance scan (plain PyTorch).

Counterpart of ``unboundednerfpytorch_tpu/ops/alpha.py``. Rays are
fixed-shape ``[N_rays, N_samples]`` with validity masks; the scan is a
per-ray cumulative product with the reference's early exit emulated by
masking. These are the plain versions: the fused CUDA form of
``raw2alpha`` + ``alpha2weights`` lives in :mod:`..ops.cuda.march`, and
this module is what it is held against.
"""

from __future__ import annotations

import torch

# The reference scan stops marching a ray once transmittance drops below this.
EARLY_EXIT_T = 1e-3


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` in the form of ``jax.nn.softplus``
    (``max(x, 0) + log1p(exp(-|x|))``); ``F.softplus`` instead passes inputs
    above 20 through linearly."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def raw2alpha(density: torch.Tensor, shift, interval) -> torch.Tensor:
    """alpha = 1 - exp(-softplus(density + shift) * interval)."""
    return 1.0 - torch.exp(-softplus(density + shift) * interval)


def alpha2weights(
    alpha: torch.Tensor,
    mask: torch.Tensor | None = None,
    early_exit_thres: float = EARLY_EXIT_T,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ray scan: w_i = T_i * alpha_i, T_{i+1} = T_i (1 - alpha_i).

    A sample is processed iff the transmittance entering it is still
    >= ``early_exit_thres`` (the CUDA loop emits the weight, then breaks).
    Returns (weights [..., S], alphainv_last [...]).
    """
    if mask is not None:
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    if early_exit_thres > 0.0:
        processed = t_excl >= early_exit_thres
        weights = t_excl * alpha * processed.to(alpha.dtype)
        stop = ~processed
        any_stop = stop.any(dim=-1)
        first_stop = stop.to(torch.int32).argmax(dim=-1)
        t_at_stop = torch.gather(t_excl, -1, first_stop[..., None].long())[..., 0]
        alphainv_last = torch.where(any_stop, t_at_stop, t_incl[..., -1])
    else:
        weights = t_excl * alpha
        alphainv_last = t_incl[..., -1]
    return weights, alphainv_last
