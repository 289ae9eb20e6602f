"""The plain reference of the recipe's train step: forward, the losses the
configuration weighs, backward by autograd, the total-variation gradient
added to the grids' gradients (dense before ``tv_dense_before``), and masked
Adam (a grid element whose gradient is 0 keeps its value and moments).

The grids are stored in the configuration's ``grid_dtype`` and their
gradients too, as the recipe's parameters are; the moments are float32.
Plain PyTorch; nothing of the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model
from benchmark.reference.recipe import Recipe

BETA1, BETA2, EPS = 0.9, 0.99, 1e-8
GRIDS = ("density", "k0")


def losses(R: Recipe, out: dict, target, near_thres: float):
    """The weighted sum of the configuration's losses over a batch."""
    ft = R.train
    n = target.shape[0]
    mask = out["mask"].to(out["weights"].dtype)
    loss = float(ft["weight_main"]) * torch.mean((out["rgb"] - target) ** 2)
    if float(ft["weight_entropy_last"]) > 0:
        p = torch.clamp(out["alphainv_last"], 1e-6, 1.0 - 1e-6)
        loss = loss + float(ft["weight_entropy_last"]) * -torch.mean(
            p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p))
    if float(ft["weight_nearclip"]) > 0 and near_thres > 0:
        near = ((out["t"] < near_thres) & out["mask"]).to(out["raw_density"].dtype)
        d = out["raw_density"]
        loss = loss + float(ft["weight_nearclip"]) * torch.sum((d - d.detach()) * near)
    if float(ft["weight_distortion"]) > 0:
        w, s = out["weights"] * mask, out["s"].to(out["weights"].dtype)
        before = torch.cumsum(w, -1) - w
        ws_before = torch.cumsum(w * s, -1) - w * s
        bi = 2.0 * w * (s * before - ws_before)
        uni = (1.0 / 3.0) * (1.0 / out["n_max"]) * w**2
        loss = loss + float(ft["weight_distortion"]) * (bi.sum() + uni.sum()) / w.shape[0]
    if float(ft["weight_rgbper"]) > 0:
        per = ((out["raw_rgb"] - target[:, None, :]) ** 2).sum(-1) * mask
        loss = loss + float(ft["weight_rgbper"]) * (per * out["weights"].detach()).sum() / n
    if float(ft.get("weight_freq", 0.0)) > 0:
        raise ValueError("the reference has no Fourier MSE loss")
    return loss


def tv_grad(param, w: float):
    """The TV gradient of a grid [B, X, Y, Z, C] in float32: along each axis
    w / 6 (clamp(p_i - p_{i+1}, -1, 1) + clamp(p_i - p_{i-1}, -1, 1))."""
    p = param.float()
    acc = torch.zeros_like(p)
    for axis in (1, 2, 3):
        n = p.shape[axis]
        diff = (p.narrow(axis, 0, n - 1) - p.narrow(axis, 1, n - 1)).clamp(-1.0, 1.0)
        acc.narrow(axis, 0, n - 1).add_(diff * (w / 6.0))
        acc.narrow(axis, 1, n - 1).sub_(diff * (w / 6.0))
    return acc


def lr_scale(R: Recipe, step: int) -> float:
    return 0.1 ** (max(step - R.lr_anchor, 0) / (int(R.train["lrate_decay"]) * 1000))


class Trainer:
    """The recipe's training state from the window's first step:
    ``params`` {"density", "k0", "mlp.<i>.weight", "mlp.<i>.bias"}, Adam's
    moments and count, the occupancy cache and the scene box."""

    def __init__(self, R: Recipe, params: dict, mask, center, radius, near_thres: float,
                 dt=torch.float32):
        self.R, self.params, self.mask = R, params, mask
        self.center, self.radius, self.near_thres, self.dt = center, radius, near_thres, dt
        self.m = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()}
        self.v = {k: torch.zeros_like(m) for k, m in self.m.items()}
        self.count = 0
        self.step_no = R.start_step - 1

    def _grads(self, rays, target, bg):
        """(loss, {name: gradient in the parameter's dtype})."""
        leaves = {k: p.detach().float().requires_grad_() for k, p in self.params.items()}
        n_mlp = len(self.R.mlp_dims)
        g = {"density": leaves["density"], "k0": leaves["k0"], "mask": self.mask,
             "center": self.center, "radius": self.radius,
             "mlp": [(leaves[f"mlp.{i}.weight"], leaves[f"mlp.{i}.bias"]) for i in range(n_mlp)]}
        out = model.forward(self.R, g, *rays, bg, dt=self.dt)
        out = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
               for k, v in out.items()}
        loss = losses(self.R, out, target, self.near_thres)
        loss.backward()
        return loss.detach(), {k: leaves[k].grad.to(self.params[k].dtype) for k in leaves}

    @torch.no_grad()
    def _update(self, grads: dict, step: int) -> None:
        ft = self.R.train
        self.count += 1
        bias = math.sqrt(1.0 - BETA2**self.count) / (1.0 - BETA1**self.count)
        skip = set(ft["skip_zero_grad_fields"])
        for k, p in self.params.items():
            group = "rgbnet" if k.startswith("mlp.") else k
            size = bias * float(ft[f"lrate_{group}"]) * lr_scale(self.R, step)
            g = grads[k].float()
            m1 = self.m[k] * BETA1 + g * (1.0 - BETA1)
            v1 = self.v[k] * BETA2 + g * (1.0 - BETA2) * g
            upd = (p.float() - size * m1 / (torch.sqrt(v1) + EPS)).to(p.dtype)
            if group in skip:
                keep = grads[k] != 0
                m1, v1, upd = (torch.where(keep, a, b) for a, b in
                               ((m1, self.m[k]), (v1, self.v[k]), (upd, p)))
            self.m[k], self.v[k] = m1, v1
            p.copy_(upd)

    def step(self, rays, target, bg):
        """One update; returns (loss, the gradients as Adam gets them)."""
        step = self.step_no + 1
        ft = self.R.train
        loss, grads = self._grads(rays, target, bg)
        gate = (step < int(ft["tv_before"]) and step > int(ft["tv_after"])
                and step % int(ft["tv_every"]) == 0)
        if gate:
            dense = step < int(ft["tv_dense_before"])
            scale = max(self.R.world_size) / 128.0
            for k in GRIDS:
                w = float(ft[f"weight_tv_{k}"])
                if w <= 0:
                    continue
                tv = tv_grad(self.params[k], w / target.shape[0] * scale)
                gk = grads[k].float()
                if not dense:
                    tv = tv * (gk != 0)
                grads[k] = (gk + tv).to(self.params[k].dtype)
                del tv, gk
        self._update(grads, step)
        self.step_no = step
        return loss, grads
