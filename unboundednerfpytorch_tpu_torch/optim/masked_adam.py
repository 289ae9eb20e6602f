"""Masked Adam.

Counterpart of ``unboundednerfpytorch_tpu/optim/masked_adam.py`` (itself the
reference's ``adam_upd_cuda`` + ``MaskedAdam``): fused Adam with the bias
correction folded into the step size and, for ``skip_zero_grad`` groups, an
update that leaves voxels whose grad is exactly zero (moments and value)
untouched. Moments are at least f32 even for bf16 grids; the update math
runs in the moment dtype and the parameter is cast back to its own.

The update is in place (parameters and moments are overwritten) to bound
memory at full width; the JAX version is functional. It is
:func:`..ops.cuda.adam.masked_adam`: on the card one launch of the fused
kernel ``csrc/adam.cu`` per parameter, over the whole tensor, with no
temporaries; on the CPU the plain version, over each parameter in slices of
at most ``MaskedAdam.CHUNK`` elements, so its temporaries (the f32 grad,
both new moments, the update and ``where``'s outputs) are those of one slice
and not six grid-sized f32 tensors. The arithmetic of an element does not
depend on the slice, so the result is the unsliced update's to the bit.

A parameter may have a per-element learning rate (``pervoxel_lr``: the
coarse density grid's normalised view counts), set with :meth:`set_per_lr`
from the trees :func:`make_per_lr` builds, the counterpart of the JAX
``make_per_lr``: its step is scaled element by element, and every element is
updated, even in a ``skip_zero_grad`` group, as the JAX update does. It is
not part of :meth:`state_dict`: the trainer computes it anew on resume.

:meth:`MaskedAdam.state_dict` holds what the JAX ``MaskedAdamState`` holds,
the step count and both moments, keyed by group name and by the position of
a parameter in its group (``convert.opt_state_to_numpy`` gives it the JAX
layout), so it outlives the parameter tensors: a checkpoint restores it into
an optimizer built on other tensors of the same shapes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.ops.cuda import adam


class ParamGroup(NamedTuple):
    name: str
    params: list
    lr: float
    skip_zero_grad: bool


def make_per_lr(trainable: dict, group_lrs: dict) -> dict:
    """{group name: [per-element lr or None for each parameter of the
    group]}: for the groups named in ``group_lrs`` (name -> [a tensor of each
    parameter's shape], e.g. ``{"density": [count / count.max()]}``) those
    tensors as f32, for every other group of ``trainable`` (name ->
    submodule or parameter, ``factory.split_trainable``) None throughout."""
    out = {}
    for name, sub in trainable.items():
        n = 1 if isinstance(sub, torch.nn.Parameter) else len(list(sub.parameters()))
        lrs = group_lrs.get(name)
        if lrs is None:
            out[name] = [None] * n
            continue
        if len(lrs) != n:
            raise ValueError(f"per_lr/{name}: {len(lrs)} tensors for {n} parameters")
        out[name] = [None if t is None else t.to(torch.float32).contiguous() for t in lrs]
    return out


class MaskedAdam:
    # elements a slice of the plain version's update on the CPU (2^26: six
    # f32 temporaries of 256 MB); the kernel on the card takes a whole tensor
    CHUNK = 1 << 26

    def __init__(self, groups: list[ParamGroup], beta1: float = 0.9, beta2: float = 0.99,
                 eps: float = 1e-8):
        self.groups = groups
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.step_count = 0
        self.exp_avg = {}
        self.exp_avg_sq = {}
        self.per_lr = {}
        for g in groups:
            for p in g.params:
                dt = torch.promote_types(p.dtype, torch.float32)
                self.exp_avg[p] = torch.zeros(p.shape, dtype=dt, device=p.device)
                self.exp_avg_sq[p] = torch.zeros(p.shape, dtype=dt, device=p.device)

    def state_dict(self) -> dict:
        """``{"step": updates since the optimizer was built, "exp_avg":
        {group: [moment of each parameter, in the group's order]},
        "exp_avg_sq": ...}``. The tensors are the optimizer's own."""
        out = {"step": self.step_count}
        for key in ("exp_avg", "exp_avg_sq"):
            moments = getattr(self, key)
            out[key] = {g.name: [moments[p] for p in g.params] for g in self.groups}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` (its moments as tensors or numpy arrays,
        on any device) into this optimizer's moments. Groups, counts and
        shapes must match."""
        for key in ("exp_avg", "exp_avg_sq"):
            moments = getattr(self, key)
            if sorted(state[key]) != sorted(g.name for g in self.groups):
                raise ValueError(f"{key}: groups {sorted(state[key])}, want "
                                 f"{sorted(g.name for g in self.groups)}")
            for g in self.groups:
                src = state[key][g.name]
                if len(src) != len(g.params):
                    raise ValueError(f"{key}/{g.name}: {len(src)} moments for "
                                     f"{len(g.params)} parameters")
                for p, s in zip(g.params, src):
                    if isinstance(s, np.ndarray):  # torch wants a writable array
                        s = torch.from_numpy(np.require(s, requirements="W"))
                    if s.shape != moments[p].shape:
                        raise ValueError(f"{key}/{g.name}: shape {tuple(s.shape)}, want "
                                         f"{tuple(moments[p].shape)}")
                    moments[p].copy_(s)
        self.step_count = int(state["step"])

    def set_per_lr(self, per_lr: dict) -> None:
        """Per-element learning rates from :func:`make_per_lr`'s tree (a
        tensor of its parameter's shape, or None for the plain update)."""
        for g in self.groups:
            for p, r in zip(g.params, per_lr.get(g.name, [None] * len(g.params))):
                if r is None:
                    self.per_lr.pop(p, None)
                    continue
                if r.shape != p.shape:
                    raise ValueError(f"per_lr/{g.name}: shape {tuple(r.shape)}, want "
                                     f"{tuple(p.shape)}")
                self.per_lr[p] = r.to(device=p.device, dtype=torch.float32).contiguous()

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
                adam.masked_adam(p, self.exp_avg[p], self.exp_avg_sq[p], p.grad, step_size,
                                 b1, b2, eps, g.skip_zero_grad, chunk=self.CHUNK,
                                 per_lr=self.per_lr.get(p))
