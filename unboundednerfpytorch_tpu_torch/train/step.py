"""The train step: forward, losses, backward, TV injection, masked Adam.

Counterpart of ``unboundednerfpytorch_tpu/train/step.py::make_train_step``,
its ``flatten`` and ``random`` samplers and its ``HostRayStoreSampler`` (the
``load2gpu_on_the_fly`` mode) in both modes. PyTorch runs eagerly, so the TV schedule gates
(tv_every / tv_after / tv_before) and the dense/sparse TV mode are host
booleans per step. TV goes into ``param.grad`` after ``backward()`` and
before the optimizer, through the fused CUDA kernel
(:func:`..ops.cuda.tv.tv_add_grad`), in place; a TensoRF grid gets the
gradient of its smooth-L1 TV loss (:func:`..ops.tv.tensorf_tv_grads`)
instead, as in the JAX package.

The step's phases run under spans (``utils/profiling.py::span``:
``train_step/forward_loss``, ``/backward``, ``/allreduce``, ``/tv``,
``/adam``), so a profiler trace attributes device time to them; without an
active profiler a span costs one flag check.

Data parallelism (``mesh``, a :class:`..parallel.mesh.Mesh`): the JAX step
is one program over the global batch, so a rank's step must add up to the
single-device step on it. Each rank holds ``1 / mesh.data`` of the global
batch; the loss terms that are means over the rays (the MSE, the Fourier
MSE, the entropy, the distortion and rgbper, which divide by the *local*
ray count) enter its backward scaled by that share, the near-clip term,
a plain sum, unscaled; the gradients are then summed over the data group;
TV takes the global ray count (``weight / N_rand``) and sees the summed
gradient, as masked Adam's skip mask does. Grids cut over a grid group get
their neighbours' boundary planes for TV (the kernel's halo launch). The
metrics are the global batch's (one all-reduce of a few scalars a step).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.models.common import RenderResult
from unboundednerfpytorch_tpu_torch.ops import losses as L
from unboundednerfpytorch_tpu_torch.ops.cuda.tv import tv_add_grad
from unboundednerfpytorch_tpu_torch.ops.tv import tensorf_tv_grads
from unboundednerfpytorch_tpu_torch.optim import factory
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam
from unboundednerfpytorch_tpu_torch.parallel import halo
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    optimizer: MaskedAdam
    step: int  # global step of the last update (the reference counts from 1)


def create_train_state(params: nn.Module, train_cfg: TrainStageConfig,
                       start_step: int = 0, opt_state: dict | None = None) -> TrainState:
    """A fresh optimizer on ``params``; with ``opt_state`` (a
    ``MaskedAdam.state_dict()``, e.g. a checkpoint's) its step count and
    moments are restored."""
    optimizer = factory.make_optimizer(params, train_cfg)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    return TrainState(params=params, optimizer=optimizer, step=start_step)


def make_train_step(
    forward_fn: Callable[..., RenderResult],
    train_cfg: TrainStageConfig,
    *,
    world_size_max: float = 128.0,
    near_thres: float = 0.0,
    tv_axis_scale: tuple | None = None,
    lr_anchor: int = 1,
    lr_decay_enabled: bool = True,
    mesh: mesh_mod.Mesh | None = None,
):
    """Build ``train_step(state, batch, bg_color=None) -> metrics``.

    ``forward_fn(params, rays_o, rays_d, viewdirs, bg_color)`` returns a
    RenderResult; where the batch holds ``img_index`` it is passed on as a
    keyword. ``world_size_max`` scales the TV weights
    (``weight * world_size.max() / 128``) of all three axes, unless
    ``tv_axis_scale`` gives one scale an axis (DMPIGO's ``(max(X, Y),
    max(X, Y), mpi_depth) / 128``); ``near_thres`` is the near-clip
    threshold in contracted units (0 disables); ``lr_anchor`` is the step at
    which the lr equals the base lr. Metrics are detached device scalars, so
    a step forces no host sync. ``mesh``: data parallelism (module doc);
    ``batch`` is then this rank's slice of the global batch.
    """
    share = 1.0 if mesh is None else 1.0 / mesh.data

    def loss_fn(params, batch, bg_color):
        # a batch of the ray store carries each ray's view (the appearance
        # embeddings' index); a forward of the loop's make_forward takes it
        extra = {"img_index": batch["img_index"]} if "img_index" in batch else {}
        res = forward_fn(params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
                         bg_color, **extra)
        target = batch["rgb"]
        n_rays = target.shape[0]
        components = {}
        mse_loss = L.mse(res.rgb_marched, target)
        loss = train_cfg.weight_main * mse_loss
        if train_cfg.weight_freq > 0:
            term = L.fourier_mse(res.rgb_marched, target)
            loss = loss + train_cfg.weight_freq * term
            components["loss_freq"] = term
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
            term = L.rgbper(res.raw_rgb, target, res.weights, n_rays, mask=res.mask,
                            rows=res.rgb_rows)
            loss = loss + train_cfg.weight_rgbper * term
            components["loss_rgbper"] = term
        metrics = {"loss": loss.detach(), "mse": mse_loss.detach(),
                   "psnr": L.mse2psnr(mse_loss.detach())}
        metrics.update({k: v.detach() for k, v in components.items()})
        if res.color_overflow_frac is not None:
            # the two-stage training forward: the share of rays with more
            # survivors than its budget (their far tail was dropped)
            metrics["overflow_frac"] = res.color_overflow_frac.detach()
        if share != 1.0:
            # this rank's share of the global loss: every term but the
            # near-clip sum is a mean over the local rays
            near = components.get("loss_nearclip")
            loss = loss * share
            if near is not None:
                loss = loss + (1.0 - share) * train_cfg.weight_nearclip * near
        return loss, metrics

    def global_metrics(metrics: dict) -> dict:
        """The global batch's metrics: the ranks' shares summed (a mean over
        rays is the mean of equal shares; the near-clip term is 0)."""
        out = mesh_mod.all_reduce_sum({k: v * share for k, v in metrics.items()
                                       if k != "psnr"}, mesh.data_group)
        out["psnr"] = L.mse2psnr(out["mse"])
        return out

    def add_tv_grads(params, step: int, n_rays: int) -> None:
        """``n_rays``: the global batch's rays."""
        """TV injection between backward and the optimizer, in place."""
        gate = (step < train_cfg.tv_before) and (step > train_cfg.tv_after) and (
            step % train_cfg.tv_every == 0)
        if not gate:
            return  # gate 0 leaves the grad as it is
        dense = step < train_cfg.tv_dense_before
        sx, sy, sz = tv_axis_scale or (world_size_max / 128.0,) * 3
        for name, weight in (("density", train_cfg.weight_tv_density),
                             ("k0", train_cfg.weight_tv_k0)):
            sub = getattr(params, name, None)
            if weight <= 0 or sub is None:
                continue
            w = weight / n_rays
            if not sub.dense:  # TensoRF: the smooth-L1 loss's gradient
                leaves = sub.leaves()
                if not leaves["xy_plane"].requires_grad:
                    continue
                for key, g in tensorf_tv_grads(leaves, w * sx, w * sy, w * sz).items():
                    p = leaves[key]
                    p.grad = g if p.grad is None else p.grad.add_(g)
                continue
            if not sub.grid.requires_grad:
                continue
            grid = sub.grid
            if grid.grad is None:
                grid.grad = torch.zeros_like(grid)
            lo = hi = None
            if sub.shard is not None:  # an x-slab: the neighbours' planes
                lo, hi = halo.exchange_boundary_planes(grid.detach(), sub.shard)
            tv_add_grad(grid.detach(), grid.grad, w * sx, w * sy, w * sz, 1.0, dense,
                        out=grid.grad, lo=lo, hi=hi)

    def train_step(state: TrainState, batch: dict, bg_color: torch.Tensor | None = None):
        step = state.step + 1
        params = state.params
        for p in params.parameters():
            p.grad = None
        with span("train_step/forward_loss"):
            loss, metrics = loss_fn(params, batch, bg_color)
        with span("train_step/backward"):
            loss.backward()
        n_rays = batch["rgb"].shape[0]
        if mesh is not None:
            with span("train_step/allreduce"):
                mesh_mod.all_reduce_grads(params, mesh)
                metrics = global_metrics(metrics)
            n_rays *= mesh.data
        with span("train_step/tv"):
            add_tv_grads(params, step, n_rays)
        lr_scale = 1.0
        if lr_decay_enabled:
            lr_scale = factory.lr_decay_scale(float(max(step - lr_anchor, 0)),
                                              train_cfg.lrate_decay)
        with span("train_step/adam"):
            state.optimizer.step(lr_scale=lr_scale)
        state.step = step
        metrics["lr_scale"] = lr_scale
        return metrics

    return train_step


class FlattenSampler:
    """Epoch-permutation ray sampler ('flatten'): a shuffled index buffer
    walked sequentially and reshuffled when the next batch would run past
    its end, so every ray is visited once per epoch. With ``rand_bkgd`` each
    batch also gets a random background colour per ray, drawn from the same
    generator just after its indices.

    Every draw comes from ``generator``, in an order fixed by the step, so
    :meth:`fast_forward` (the draws of ``n`` batches, thrown away) stands the
    sampler where an uninterrupted run stands after ``n`` steps."""

    def __init__(self, n_total: int, n_rand: int, generator: torch.Generator,
                 device: torch.device, rand_bkgd: bool = False):
        self.n_total, self.n_rand = int(n_total), int(n_rand)
        self.generator, self.device, self.rand_bkgd = generator, device, rand_bkgd
        self._shuffle()

    def _shuffle(self) -> None:
        self.perm = torch.randperm(self.n_total, generator=self.generator, device=self.device)
        self.cursor = 0

    def next_batch(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(ray indices [n_rand], background colours [n_rand, 3] or None)."""
        if self.cursor + self.n_rand > self.n_total:
            self._shuffle()
        idx = self.perm[self.cursor:self.cursor + self.n_rand]
        self.cursor += self.n_rand
        bg = None
        if self.rand_bkgd:
            bg = torch.rand((idx.shape[0], 3), generator=self.generator, device=self.device)
        return idx, bg

    def fast_forward(self, n: int) -> None:
        for _ in range(n):
            self.next_batch()


class RandomSampler(FlattenSampler):
    """The ``random`` sampler: each batch ``n_rand`` indices drawn uniformly
    with replacement (``torch.randint``), and, with ``rand_bkgd``, its
    backgrounds after them, all from ``generator``; :meth:`fast_forward`
    replays the draws of ``n`` batches."""

    def _shuffle(self) -> None:
        pass

    def next_batch(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        idx = torch.randint(self.n_total, (self.n_rand,), generator=self.generator,
                            device=self.device)
        bg = None
        if self.rand_bkgd:
            bg = torch.rand((self.n_rand, 3), generator=self.generator, device=self.device)
        return idx, bg


class HostRayStoreSampler:
    """The ``load2gpu_on_the_fly`` sampler: the flattened ray store stays in
    host memory (numpy) and only each step's batch crosses to the device, so
    the scene is bounded by host memory, not by the card's.

    The indices are the JAX ``HostRayStoreSampler``'s for the same seed and
    ``mode``: in 'flatten' mode an epoch permutation from
    ``np.random.default_rng(seed)``, walked in order and drawn anew when the
    next batch would run past its end; in 'random' mode ``n_rand`` indices
    drawn with replacement (``rng.integers``) a batch. The batch's rows are
    gathered into a pinned staging buffer (on a CUDA device) that every step
    reuses, and copied to the device in one
    asynchronous copy; the next gather waits for that copy to have left the
    buffer. Given ``bg_generator`` (the ``rand_bkgd`` configs) each batch
    also gets a random background per ray, drawn on the device from it (as
    :class:`FlattenSampler` draws it), so :meth:`fast_forward` replays both
    streams and a resumed run draws what the uninterrupted one draws. A
    store with ``img_index`` hands each batch its rays' views too (through a
    second, int32 staging buffer), as the device sampler does. ``part``
    (data parallelism): the draws are the global batch's, and only the rows
    of this slice of it are gathered and copied."""

    COLUMNS = {"rgb": (0, 3), "rays_o": (3, 6), "rays_d": (6, 9), "viewdirs": (9, 12)}

    def __init__(self, store: dict, n_rand: int, seed: int, device: torch.device,
                 bg_generator: torch.Generator | None = None, mode: str = "flatten",
                 part: slice | None = None):
        if mode not in ("flatten", "random"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        self.mode = mode
        self.store = {k: np.asarray(store[k], np.float32) for k in self.COLUMNS}
        self.img_index = (np.asarray(store["img_index"], np.int32) if "img_index" in store
                          else None)
        self.n_total = int(self.store["rgb"].shape[0])
        self.n_rand = int(n_rand)
        self.device = torch.device(device)
        self.bg_generator = bg_generator
        self._rng = np.random.default_rng(seed)
        self._perm = None
        self._cursor = 0
        self.part = slice(0, self.n_rand) if part is None else part
        n_part = len(range(self.n_rand)[self.part])
        pinned = self.device.type == "cuda"
        self._stage = torch.empty((n_part, 12), dtype=torch.float32, pin_memory=pinned)
        self._stage_idx = (None if self.img_index is None else
                           torch.empty((n_part,), dtype=torch.int32, pin_memory=pinned))
        self._copied = None  # event recorded after the last copy out of the stage

    def next_indices(self) -> np.ndarray:
        if self.mode == "random":
            return self._rng.integers(0, self.n_total, size=self.n_rand)
        if self._perm is None or self._cursor + self.n_rand > self.n_total:
            self._perm = self._rng.permutation(self.n_total)
            self._cursor = 0
        idx = self._perm[self._cursor:self._cursor + self.n_rand]
        self._cursor += self.n_rand
        return idx

    def _next_bg(self) -> torch.Tensor | None:
        if self.bg_generator is None:
            return None
        return torch.rand((self.n_rand, 3), generator=self.bg_generator, device=self.device)

    def next_batch(self) -> tuple[dict, torch.Tensor | None]:
        """(batch of rgb, rays_o, rays_d, viewdirs [n_rand, 3] (and img_index
        [n_rand]) on the device, background colours [n_rand, 3] or None)."""
        idx = self.next_indices()[self.part]
        if self._copied is not None:
            self._copied.synchronize()
        stage = self._stage.numpy()
        for key, (a, b) in self.COLUMNS.items():
            stage[:, a:b] = self.store[key][idx]
        rows = self._stage.to(self.device, non_blocking=True, copy=True)
        if self._stage_idx is not None:
            self._stage_idx.numpy()[:] = self.img_index[idx]
            views = self._stage_idx.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        batch = {key: rows[:, a:b] for key, (a, b) in self.COLUMNS.items()}
        if self._stage_idx is not None:
            batch["img_index"] = views
        bg = self._next_bg()
        return batch, None if bg is None else bg[self.part]

    def fast_forward(self, n: int) -> None:
        for _ in range(n):
            self.next_indices()
            self._next_bg()
