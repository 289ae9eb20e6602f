"""The train step: forward, losses, backward, TV injection, masked Adam.

Counterpart of ``unboundednerfpytorch_tpu/train/step.py::make_train_step``
and its ``flatten`` sampler. PyTorch runs eagerly, so the TV schedule gates
(tv_every / tv_after / tv_before) and the dense/sparse TV mode are host
booleans per step. TV goes into ``param.grad`` after ``backward()`` and
before the optimizer, through the fused CUDA kernel
(:func:`..ops.cuda.tv.tv_add_grad`), in place.

The step's phases run under ``torch.profiler.record_function`` ranges
(``train_step/forward_loss``, ``/backward``, ``/tv``, ``/adam``), so a
profiler trace attributes device time to them; without an active profiler
a range costs a few microseconds of host time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.profiler import record_function

from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.models.common import RenderResult
from unboundednerfpytorch_tpu_torch.ops import losses as L
from unboundednerfpytorch_tpu_torch.ops.cuda.tv import tv_add_grad
from unboundednerfpytorch_tpu_torch.optim import factory
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    optimizer: MaskedAdam
    step: int  # global step of the last update (the reference counts from 1)


def create_train_state(params: nn.Module, train_cfg: TrainStageConfig,
                       start_step: int = 0) -> TrainState:
    return TrainState(params=params, optimizer=factory.make_optimizer(params, train_cfg),
                      step=start_step)


def make_train_step(
    forward_fn: Callable[..., RenderResult],
    train_cfg: TrainStageConfig,
    *,
    world_size_max: float = 128.0,
    near_thres: float = 0.0,
    lr_anchor: int = 1,
    lr_decay_enabled: bool = True,
):
    """Build ``train_step(state, batch, bg_color=None) -> metrics``.

    ``forward_fn(params, rays_o, rays_d, viewdirs, bg_color)`` returns a
    RenderResult. ``world_size_max`` scales the TV weights
    (``weight * world_size.max() / 128``); ``near_thres`` is the near-clip
    threshold in contracted units (0 disables); ``lr_anchor`` is the step at
    which the lr equals the base lr. Metrics are detached device scalars, so
    a step forces no host sync.
    """

    def loss_fn(params, batch, bg_color):
        res = forward_fn(params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
                         bg_color)
        target = batch["rgb"]
        n_rays = target.shape[0]
        components = {}
        mse_loss = L.mse(res.rgb_marched, target)
        loss = train_cfg.weight_main * mse_loss
        if train_cfg.weight_freq > 0:
            raise NotImplementedError("weight_freq (Fourier MSE) is not ported yet")
        if train_cfg.weight_entropy_last > 0:
            term = L.entropy_last(res.alphainv_last)
            loss = loss + train_cfg.weight_entropy_last * term
            components["loss_entropy"] = term
        if train_cfg.weight_nearclip > 0 and near_thres > 0:
            term = L.nearclip(res.raw_density, res.t, near_thres, mask=res.mask)
            loss = loss + train_cfg.weight_nearclip * term
            components["loss_nearclip"] = term
        if train_cfg.weight_distortion > 0:
            term = L.distortion(res.weights, res.s, res.n_max, mask=res.mask)
            loss = loss + train_cfg.weight_distortion * term
            components["loss_distortion"] = term
        if train_cfg.weight_rgbper > 0:
            term = L.rgbper(res.raw_rgb, target, res.weights, n_rays, mask=res.mask)
            loss = loss + train_cfg.weight_rgbper * term
            components["loss_rgbper"] = term
        metrics = {"loss": loss.detach(), "mse": mse_loss.detach(),
                   "psnr": L.mse2psnr(mse_loss.detach())}
        metrics.update({k: v.detach() for k, v in components.items()})
        return loss, metrics

    def add_tv_grads(params, step: int, n_rays: int) -> None:
        """TV injection between backward and the optimizer, in place."""
        gate = (step < train_cfg.tv_before) and (step > train_cfg.tv_after) and (
            step % train_cfg.tv_every == 0)
        if not gate:
            return  # gate 0 leaves the grad as it is
        dense = step < train_cfg.tv_dense_before
        s = world_size_max / 128.0
        for name, weight in (("density", train_cfg.weight_tv_density),
                             ("k0", train_cfg.weight_tv_k0)):
            sub = getattr(params, name, None)
            if weight <= 0 or sub is None or not sub.grid.requires_grad:
                continue
            grid = sub.grid
            if grid.grad is None:
                grid.grad = torch.zeros_like(grid)
            w = weight / n_rays * s
            tv_add_grad(grid.detach(), grid.grad, w, w, w, 1.0, dense, out=grid.grad)

    def train_step(state: TrainState, batch: dict, bg_color: torch.Tensor | None = None):
        step = state.step + 1
        params = state.params
        for p in params.parameters():
            p.grad = None
        with record_function("train_step/forward_loss"):
            loss, metrics = loss_fn(params, batch, bg_color)
        with record_function("train_step/backward"):
            loss.backward()
        with record_function("train_step/tv"):
            add_tv_grads(params, step, batch["rgb"].shape[0])
        lr_scale = 1.0
        if lr_decay_enabled:
            lr_scale = factory.lr_decay_scale(float(max(step - lr_anchor, 0)),
                                              train_cfg.lrate_decay)
        with record_function("train_step/adam"):
            state.optimizer.step(lr_scale=lr_scale)
        state.step = step
        metrics["lr_scale"] = lr_scale
        return metrics

    return train_step


class FlattenSampler:
    """Epoch-permutation ray sampler ('flatten'): a shuffled index buffer
    walked sequentially and reshuffled when the next batch would run past
    its end, so every ray is visited once per epoch."""

    def __init__(self, n_total: int, n_rand: int, generator: torch.Generator,
                 device: torch.device):
        self.n_total, self.n_rand = int(n_total), int(n_rand)
        self.generator, self.device = generator, device
        self._shuffle()

    def _shuffle(self) -> None:
        self.perm = torch.randperm(self.n_total, generator=self.generator, device=self.device)
        self.cursor = 0

    def next_indices(self) -> torch.Tensor:
        if self.cursor + self.n_rand > self.n_total:
            self._shuffle()
        idx = self.perm[self.cursor:self.cursor + self.n_rand]
        self.cursor += self.n_rand
        return idx
