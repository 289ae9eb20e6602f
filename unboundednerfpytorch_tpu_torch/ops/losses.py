"""Training losses.

Counterpart of ``unboundednerfpytorch_tpu/ops/losses.py``: photometric MSE,
background entropy, per-point rgb loss, near-clip and the ray distortion
loss (prefix-sum form), over fixed-shape ``[N_rays, N_samples]`` tensors;
autograd supplies the backward.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(x)


def entropy_last(alphainv_last: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(alphainv_last, 1e-6, 1.0 - 1e-6)
    return -torch.mean(p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))


def rgbper(raw_rgb: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, n_rays: int,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point color loss weighted by the detached marching weights."""
    per = torch.sum((raw_rgb - target[:, None, :]) ** 2, dim=-1)
    w = weights.detach()
    if mask is not None:
        per = per * mask.to(per.dtype)
    return torch.sum(per * w) / n_rays


def distortion(weights: torch.Tensor, s: torch.Tensor, n_max: int,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """mean_rays[ sum_ij w_i w_j |s_i - s_j| + (1/3)(1/n_max) sum w_i^2 ]
    via the prefix-sum identity."""
    if mask is not None:
        weights = weights * mask.to(weights.dtype)
    interval = 1.0 / n_max
    w_prefix = torch.cumsum(weights, dim=-1) - weights
    ws_prefix = torch.cumsum(weights * s, dim=-1) - weights * s
    loss_bi = 2.0 * weights * (s * w_prefix - ws_prefix)
    loss_uni = (1.0 / 3.0) * interval * weights**2
    return (torch.sum(loss_bi) + torch.sum(loss_uni)) / weights.shape[0]


def nearclip(raw_density: torch.Tensor, t: torch.Tensor, near_thres: float,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-valued loss whose gradient w.r.t. density is the near mask
    ((t < thres) & mask): a constant push-down on near-camera density."""
    near_mask = t < near_thres
    if mask is not None:
        near_mask = near_mask & mask
    near_mask = near_mask.to(raw_density.dtype)
    return torch.sum((raw_density - raw_density.detach()) * near_mask)
