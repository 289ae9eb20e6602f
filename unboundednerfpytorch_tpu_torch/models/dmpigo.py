"""DMPIGO: forward-facing NDC scenes as a multiplane image (the ``llff/*.py``
configs).

Counterpart of ``unboundednerfpytorch_tpu/models/dmpigo.py``: world size
``[X, Y, mpi_depth]``, a per-depth ``act_shift`` that gives every plane the
same initial alpha (a buffer, not trained), sampled at each point's z;
equidistant NDC sampling; the occupancy cache and ``fast_color_thres``
before and after the scan; ``build_render_cache``, ``scale_volume_grid``
(which keeps ``mpi_depth``) and ``update_occupancy_cache``.

Density and k0 are one-bank :class:`..fields.grids.DenseGrid` s in f32. The
scan is the fused CUDA march on ``density + act_shift(z)`` with ``shift =
0`` and ``interval = stepsize * 256 / mpi_depth``. The train step weighs the
TV of the xy axes by ``max(X, Y) / 128`` and that of z by ``mpi_depth /
128`` (``train/loop.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.fields.grids import DenseGrid, MaskGrid
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.models import dcvgo
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DMPIGOConfig:
    xyz_min: tuple
    xyz_max: tuple
    num_voxels: int
    mpi_depth: int = 128
    fast_color_thres: float = 0.0
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    rgbnet_dim: int = 0
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 0
    mask_cache_world_size: tuple | None = None
    stepsize: float = 1.0

    @property
    def world_size(self) -> tuple:
        """[X, Y] from num_voxels / mpi_depth over the xy extent; Z = mpi_depth."""
        ext = np.array(self.xyz_max) - np.array(self.xyz_min)
        r = np.sqrt(self.num_voxels / self.mpi_depth / (ext[0] * ext[1]))
        return (int(ext[0] * r), int(ext[1] * r), int(self.mpi_depth))

    @property
    def voxel_size_ratio(self) -> float:
        return 256.0 / self.mpi_depth

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def rgbnet_in_dim(self) -> int:
        return 3 + 3 * self.viewbase_pe * 2 + self.k0_dim

    def n_samples(self, stepsize: float) -> int:
        return int((self.mpi_depth - 1) / stepsize) + 1

    def with_num_voxels(self, num_voxels: int) -> "DMPIGOConfig":
        return dataclasses.replace(self, num_voxels=num_voxels)


def config_from(cfg_model, xyz_min, xyz_max, num_voxels) -> DMPIGOConfig:
    return DMPIGOConfig(
        xyz_min=tuple(float(v) for v in xyz_min),
        xyz_max=tuple(float(v) for v in xyz_max),
        num_voxels=num_voxels,
        mpi_depth=cfg_model.mpi_depth,
        fast_color_thres=normalize_fast_color_thres(cfg_model)[0],
        density_type=cfg_model.density_type,
        k0_type=cfg_model.k0_type,
        rgbnet_dim=cfg_model.rgbnet_dim,
        rgbnet_depth=cfg_model.rgbnet_depth,
        rgbnet_width=cfg_model.rgbnet_width,
        stepsize=cfg_model.stepsize,
    )


def init_act_shift(mpi_depth: int, voxel_size_ratio: float) -> np.ndarray:
    """Per-plane bias that makes every plane's initial alpha equal: f32 [D]."""
    g = np.full([mpi_depth], 1.0 / mpi_depth - 1e-6)
    p = [1 - g[0]]
    for i in range(1, len(g)):
        p.append((1 - g[: i + 1].sum()) / (1 - g[:i].sum()))
    return np.array([np.log(pi ** (-1.0 / voxel_size_ratio) - 1.0) for pi in p], np.float32)


class DMPIGOParams(nn.Module):
    """density [1, X, Y, D, 1], k0 [1, X, Y, D, k0_dim], the rgb MLP (None
    without ``rgbnet_dim``), ``act_shift`` [D] (a buffer) and the occupancy
    cache."""

    def __init__(self, density: DenseGrid, k0: DenseGrid, rgbnet: MLP | None,
                 act_shift: torch.Tensor, mask_cache: MaskGrid):
        super().__init__()
        self.density = density
        self.k0 = k0
        self.rgbnet = rgbnet
        self.register_buffer("act_shift", act_shift.to(torch.float32))
        self.mask_cache = mask_cache


def create(cfg: DMPIGOConfig, generator: torch.Generator | None = None,
           device=None) -> DMPIGOParams:
    ws = cfg.world_size
    density = DenseGrid(1, ws, cfg.xyz_min, cfg.xyz_max, device=device)
    k0 = DenseGrid(cfg.k0_dim, ws, cfg.xyz_min, cfg.xyz_max, device=device)
    rgbnet = None
    if cfg.rgbnet_dim > 0:
        rgbnet = MLP(cfg.rgbnet_in_dim, cfg.rgbnet_width, 3, cfg.rgbnet_depth,
                     generator=generator, device=device)
    shift = torch.from_numpy(init_act_shift(cfg.mpi_depth, cfg.voxel_size_ratio)).to(device)
    mask_cache = MaskGrid(cfg.mask_cache_world_size or ws, cfg.xyz_min, cfg.xyz_max,
                          device=device)
    return DMPIGOParams(density, k0, rgbnet, shift, mask_cache)


def act_shift_at(params: DMPIGOParams, cfg: DMPIGOConfig, pts: torch.Tensor) -> torch.Tensor:
    """The per-plane bias sampled at the points' z (the reference keeps it as
    a [1, 1, D] grid): [N, S]."""
    z01 = (pts[..., 2] - cfg.xyz_min[2]) / (cfg.xyz_max[2] - cfg.xyz_min[2])
    coords = torch.stack([torch.zeros_like(z01), torch.zeros_like(z01), z01], dim=-1)
    return interp.grid_sample_3d(params.act_shift[None, None, :, None], coords)[..., 0]


def build_render_cache(params: DMPIGOParams, cfg: DMPIGOConfig, log_fn=None):
    """The packed density+k0 table (as DCVGO's), or None."""
    return dcvgo.build_render_cache(params, cfg, log_fn)


def forward(
    params: DMPIGOParams,
    cfg: DMPIGOConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    stepsize: float | None = None,
    bg: float = 1.0,
    bg_color: torch.Tensor | None = None,
    cache: torch.Tensor | None = None,
    compact: bool = False,
) -> common.RenderResult:
    """Volume rendering of NDC rays. ``bg_color`` [N, 3] is the random
    background of ``rand_bkgd`` training, else ``bg`` is composited.
    ``compact``: k0 and the colours only at the samples over both thresholds
    (:func:`..common.colour`), raw_rgb [K, 3] at ``rgb_rows``; else at every
    sample."""
    stepsize = cfg.stepsize if stepsize is None else stepsize
    N = rays_o.shape[0]
    S = cfg.n_samples(stepsize)
    interval = stepsize * cfg.voxel_size_ratio
    with common.sample_grad(rays_o, rays_d), span("forward/sample"):
        pts, mask, t = sampling.sample_ndc_pts_on_rays(rays_o, rays_d, cfg.xyz_min,
                                                       cfg.xyz_max, S)
        mask = mask & params.mask_cache(pts)
        shift = act_shift_at(params, cfg, pts)
    with span("forward/density_k0"):
        raw, k0_at = dcvgo.query_density(params, pts, cache)
        density = raw + shift
    with span("forward/march"):
        alpha, weights, alphainv_last, mask = common.march(density, mask, 0.0, interval,
                                                           cfg.fast_color_thres)
    with span("forward/rgb"):
        rgb_marched, rgb, rows = common.colour(
            mask, weights, alphainv_last, bg if bg_color is None else bg_color, viewdirs, k0_at,
            lambda k0, vd: common.rgb_head(params.rgbnet, k0, vd, cfg.viewbase_pe), compact)
    step_ids = torch.arange(S, dtype=weights.dtype, device=weights.device)[None, :]
    s = ((step_ids + 0.5) / S).expand(N, S)
    return common.RenderResult(
        rgb_marched=rgb_marched,
        alphainv_last=alphainv_last,
        weights=weights,
        raw_alpha=alpha,
        raw_rgb=rgb,
        raw_density=density,
        mask=mask,
        t=t,
        s=s,
        depth=torch.sum(weights * s, dim=-1),
        n_max=S,
        rgb_rows=rows,
    )


def scale_volume_grid(params: DMPIGOParams, cfg: DMPIGOConfig, num_voxels: int,
                      report: dict | None = None):
    """The xy resolution upsampled, ``mpi_depth`` kept (the world size's
    rule); otherwise :func:`..dcvgo.resize_and_refresh`, whose refreshed alpha
    carries the per-plane bias. Returns (params, new config)."""
    new_cfg = cfg.with_num_voxels(num_voxels)
    dcvgo.resize_and_refresh(
        params, cfg, new_cfg,
        lambda d: alpha_ops.raw2alpha(d + params.act_shift[None, None, :], 0.0,
                                      new_cfg.voxel_size_ratio), report)
    return params, new_cfg


def update_occupancy_cache(params: DMPIGOParams, cfg: DMPIGOConfig) -> DMPIGOParams:
    """:func:`..dcvgo.refresh_occupancy` on the density without the
    per-plane bias, as the JAX package has it; in place, returns ``params``."""
    return dcvgo.refresh_occupancy(
        params, cfg, lambda d: alpha_ops.raw2alpha(d, 0.0, cfg.voxel_size_ratio))
