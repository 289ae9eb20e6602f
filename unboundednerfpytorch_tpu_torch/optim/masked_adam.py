"""Masked Adam.

Counterpart of ``unboundednerfpytorch_tpu/optim/masked_adam.py`` (itself the
reference's ``adam_upd_cuda`` + ``MaskedAdam``): fused Adam with the bias
correction folded into the step size and, for ``skip_zero_grad`` groups, an
update that leaves voxels whose grad is exactly zero (moments and value)
untouched. Moments are at least f32 even for bf16 grids; the update math
runs in the moment dtype and the parameter is cast back to its own.

The update is in place (parameters and moments are overwritten) to bound
memory at full width; the JAX version is functional. Per-element learning
rates (``pervoxel_lr``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ParamGroup(NamedTuple):
    name: str
    params: list
    lr: float
    skip_zero_grad: bool


class MaskedAdam:
    def __init__(self, groups: list[ParamGroup], beta1: float = 0.9, beta2: float = 0.99,
                 eps: float = 1e-8):
        self.groups = groups
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.step_count = 0
        self.exp_avg = {}
        self.exp_avg_sq = {}
        for g in groups:
            for p in g.params:
                dt = torch.promote_types(p.dtype, torch.float32)
                self.exp_avg[p] = torch.zeros(p.shape, dtype=dt, device=p.device)
                self.exp_avg_sq[p] = torch.zeros(p.shape, dtype=dt, device=p.device)

    @torch.no_grad()
    def step(self, lr_scale: float = 1.0) -> None:
        """One update from each parameter's ``.grad`` (a missing grad counts
        as zero)."""
        self.step_count += 1
        b1, b2, eps = self.beta1, self.beta2, self.eps
        t = float(self.step_count)
        bias_corr = math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
        for g in self.groups:
            step_size = g.lr * lr_scale * bias_corr
            for p in g.params:
                m = self.exp_avg[p]
                v = self.exp_avg_sq[p]
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                grad = grad.to(m.dtype)
                m1 = m * b1 + grad * (1.0 - b1)
                v1 = v * b2 + grad * (1.0 - b2) * grad
                upd = (p.to(m.dtype) - step_size * m1 / (torch.sqrt(v1) + eps)).to(p.dtype)
                if g.skip_zero_grad:
                    keep = grad != 0
                    del grad
                    m.copy_(torch.where(keep, m1, m))
                    v.copy_(torch.where(keep, v1, v))
                    p.copy_(torch.where(keep, upd, p))
                else:
                    m.copy_(m1)
                    v.copy_(v1)
                    p.copy_(upd)
