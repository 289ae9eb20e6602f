"""DCVGO: unbounded inward scenes through a Mip-NeRF-360-style contraction
(DVGO v2, the paper's baseline; the ``nerf_unbounded/<scene>.py`` configs).

Counterpart of ``unboundednerfpytorch_tpu/models/dcvgo.py``: ``DCVGOConfig``,
``config_from``, ``create``, ``sample_ray`` (linspace[0, 2] inside, 2/s
outside, ``t_boundary=2``), ``forward`` (the ``cumdist_thres`` oversample
skip, the occupancy cache, ``fast_color_thres`` before and after the scan,
the rgb MLP on k0 and the view-direction embedding, composition on ``bg`` or
on a random background, ``depth`` and ``wsum_mid``), ``build_render_cache``,
``scale_volume_grid`` and ``update_occupancy_cache``.

Density and k0 are one-bank :class:`..fields.grids.DenseGrid` s, ``[1, X, Y,
Z, C]`` in the port's layout, so the index-add backward, the TV kernel and
the resize are the FourierGrid family's. The scan is the fused CUDA march
with ``shift = act_shift`` and ``interval = stepsize * voxel_size_ratio``;
the oversample skip is the CUDA kernel of :mod:`..ops.cuda.ub360`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.device import constant, seconds_since
from unboundednerfpytorch_tpu_torch.fields.grids import DenseGrid, MaskGrid, _norm01
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.ops import packed as packed_ops
from unboundednerfpytorch_tpu_torch.ops.cuda.ub360 import cumdist_thres
from unboundednerfpytorch_tpu_torch.parallel import halo
from unboundednerfpytorch_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DCVGOConfig:
    """``scene_center`` / ``scene_radius`` map world rays into the contracted
    cube [-1-bg_len, 1+bg_len]^3 that the grids live in."""

    scene_center: tuple
    scene_radius: tuple
    num_voxels: int
    num_voxels_base: int
    alpha_init: float = 1e-6
    fast_color_thres: float = 0.0
    bg_len: float = 0.2
    contracted_norm: str = "inf"
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    rgbnet_dim: int = 0
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4
    mask_cache_world_size: tuple | None = None
    stepsize: float = 0.5
    grid_dtype: str = "float32"

    @property
    def xyz_min(self) -> tuple:
        b = 1.0 + self.bg_len
        return (-b, -b, -b)

    @property
    def xyz_max(self) -> tuple:
        b = 1.0 + self.bg_len
        return (b, b, b)

    @property
    def voxel_size(self) -> float:
        ext = np.prod(np.array(self.xyz_max) - np.array(self.xyz_min))
        return float((ext / self.num_voxels) ** (1.0 / 3.0))

    @property
    def voxel_size_base(self) -> float:
        ext = np.prod(np.array(self.xyz_max) - np.array(self.xyz_min))
        return float((ext / self.num_voxels_base) ** (1.0 / 3.0))

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def world_size(self) -> tuple:
        ext = np.array(self.xyz_max) - np.array(self.xyz_min)
        return tuple(int(v) for v in (ext / self.voxel_size).astype(np.int64))

    @property
    def world_len(self) -> int:
        return self.world_size[0]

    @property
    def n_inner(self) -> int:
        """Samples inside the unit region: int(2 / (2 + 2 bg_len) * world_len
        / stepsize) + 1; as many again outside."""
        return int(2 / (2 + 2 * self.bg_len) * self.world_len / self.stepsize) + 1

    @property
    def act_shift(self) -> float:
        return common.act_shift_from_alpha_init(self.alpha_init)

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def rgbnet_in_dim(self) -> int:
        return 3 + 3 * self.viewbase_pe * 2 + self.k0_dim

    def with_num_voxels(self, num_voxels: int) -> "DCVGOConfig":
        return dataclasses.replace(self, num_voxels=num_voxels)


def config_from(cfg_model, xyz_min, xyz_max, num_voxels) -> DCVGOConfig:
    """From a ModelRenderConfig and the world bbox. FourierGrid's own keys
    (``sample_budget``, ``color_budget``, ``density_bake_scale``, ...) are
    ignored, as in the JAX package, and so are ``density_type`` and
    ``k0_type``: the JAX family builds dense grids whatever they say."""
    xyz_min = np.asarray(xyz_min, np.float64)
    xyz_max = np.asarray(xyz_max, np.float64)
    return DCVGOConfig(
        scene_center=tuple(((xyz_min + xyz_max) * 0.5).tolist()),
        scene_radius=tuple(((xyz_max - xyz_min) * 0.5).tolist()),
        num_voxels=num_voxels,
        num_voxels_base=cfg_model.num_voxels_base_rgb,
        alpha_init=cfg_model.alpha_init,
        fast_color_thres=normalize_fast_color_thres(cfg_model)[0],
        bg_len=cfg_model.bg_len,
        contracted_norm=cfg_model.contracted_norm,
        density_type=cfg_model.density_type,
        k0_type=cfg_model.k0_type,
        rgbnet_dim=cfg_model.rgbnet_dim,
        rgbnet_depth=cfg_model.rgbnet_depth,
        rgbnet_width=cfg_model.rgbnet_width,
        stepsize=cfg_model.stepsize,
        grid_dtype=cfg_model.grid_dtype,
    )


class DCVGOParams(nn.Module):
    """density [1, X, Y, Z, 1], k0 [1, X, Y, Z, k0_dim], the rgb MLP (None
    without ``rgbnet_dim``), ``act_shift`` (a host float, as FourierGrid's)
    and the occupancy cache."""

    def __init__(self, density: DenseGrid, k0: DenseGrid, rgbnet: MLP | None,
                 act_shift: float, mask_cache: MaskGrid):
        super().__init__()
        self.density = density
        self.k0 = k0
        self.rgbnet = rgbnet
        self.act_shift = float(act_shift)
        self.mask_cache = mask_cache


def create(cfg: DCVGOConfig, generator: torch.Generator | None = None,
           device=None) -> DCVGOParams:
    """Zero grids, an all-true occupancy cache and a U(+-1/sqrt(fan_in)) MLP
    drawn from ``generator`` (a CPU generator; values are then moved)."""
    ws = cfg.world_size
    dt = fg._DTYPES[cfg.grid_dtype]
    density = DenseGrid(1, ws, cfg.xyz_min, cfg.xyz_max, dtype=dt, device=device)
    k0 = DenseGrid(cfg.k0_dim, ws, cfg.xyz_min, cfg.xyz_max, dtype=dt, device=device)
    rgbnet = None
    if cfg.rgbnet_dim > 0:
        rgbnet = MLP(cfg.rgbnet_in_dim, cfg.rgbnet_width, 3, cfg.rgbnet_depth,
                     generator=generator, device=device)
    mask_cache = MaskGrid(cfg.mask_cache_world_size or ws, cfg.xyz_min, cfg.xyz_max,
                          device=device)
    return DCVGOParams(density, k0, rgbnet, cfg.act_shift, mask_cache)


def activate_density(params: DCVGOParams, cfg: DCVGOConfig, density: torch.Tensor,
                     interval: float | None = None) -> torch.Tensor:
    interval = cfg.voxel_size_ratio if interval is None else interval
    return alpha_ops.raw2alpha(density, params.act_shift, interval)


def sample_ray(cfg: DCVGOConfig, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Contracted central sampling: (pts [N, S, 3], inner [N, S], t [S])."""
    center = constant(cfg.scene_center, rays_o.dtype, rays_o.device)
    radius = constant(cfg.scene_radius, rays_o.dtype, rays_o.device)
    o = (rays_o - center) / radius
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    t = sampling.contracted_t_values(cfg.n_inner, cfg.n_inner, t_boundary=2.0,
                                     dtype=rays_o.dtype, device=rays_o.device)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    pts, inner = sampling.contract(pts, bg_len=cfg.bg_len, norm_type=cfg.contracted_norm)
    return pts, inner, t


def oversample_mask(cfg: DCVGOConfig, pts: torch.Tensor, inner: torch.Tensor,
                    stepsize: float) -> torch.Tensor:
    """The samples the forward keeps before the occupancy cache: every inner
    point, and each outer point whose contracted path from the last kept one
    is at least 0.95 of a step long (``cumdist_thres``)."""
    dist_thres = (2 + 2 * cfg.bg_len) / cfg.world_len * stepsize * 0.95
    diff = pts[:, 1:] - pts[:, :-1]
    dist = torch.sqrt((diff * diff).sum(-1))
    mask = inner.clone()
    mask[:, 1:] |= cumdist_thres(dist, dist_thres)
    return mask


def query_density(params: DCVGOParams, pts: torch.Tensor, cache: torch.Tensor | None = None):
    """(density [N, S] in f32 at every point, ``k0_at``): ``k0_at(rows)``
    gives k0 in f32 at the flat indices ``rows`` of the points
    (:func:`..common.rows_of`: [K, k0_dim], or [N, S, k0_dim] for None), so
    that k0 is looked up after the march, where it is needed. With the render
    ``cache`` (:func:`build_render_cache`) both come from one packed lookup
    at every point. On one lattice (always, but after a mask-only change) the
    corners are found once for both grids; a field without a voxel grid
    (TensoRF) or whose grid is cut over a grid group (the halo sample) is
    queried itself, k0 at the given points alone."""
    if cache is not None:
        dims = params.density.grid.shape[1:4]
        c01 = _norm01(pts, params.density.xyz_min, params.density.xyz_max)
        base, w = packed_ops.corner_base_and_weights(c01, dims)
        vals = packed_ops.packed_trilerp(cache, base, w, 1 + params.k0.grid.shape[-1])
        return vals[..., 0], lambda rows: common.rows_of(vals, rows)[..., 1:]
    if not (params.density.dense and params.k0.dense) or \
            params.density.world_size != params.k0.world_size or \
            params.density.shard is not None or params.k0.shard is not None:
        return params.density(pts)[..., 0], lambda rows: params.k0(common.rows_of(pts, rows))
    dg, kg = params.density.grid, params.k0.grid
    c01 = _norm01(pts, params.density.xyz_min, params.density.xyz_max)
    idx, w = interp.trilerp_corners(c01, dg.shape[1:4])
    density = interp.gather_trilerp(dg.reshape(-1, 1), idx, w)[..., 0]
    kflat = kg.reshape(-1, kg.shape[-1])
    return density, lambda rows: interp.gather_trilerp(kflat, common.rows_of(idx, rows),
                                                       common.rows_of(w, rows))


def build_render_cache(params: DCVGOParams, cfg: DCVGOConfig, log_fn=None):
    """The packed-corner table of density and k0 together ([T, 8 (1 +
    k0_dim)], ops/packed.py) for rendering with frozen params, or None where
    the two grids differ in size or the table is over the memory guard (the
    FourierGrid family's share of the device's memory)."""
    dg, kg = params.density.grid.detach(), params.k0.grid.detach()
    if dg.shape[1:4] != kg.shape[1:4]:
        return None
    need = packed_ops.packed_table_bytes(dg.shape[1:4], 1 + kg.shape[-1], dg.element_size())
    if need > fg._pack_bytes_limit(dg.device):
        return None
    with torch.no_grad(), span("render/cache_build"):
        table = packed_ops.pack_corners(torch.cat([dg[0], kg[0]], dim=-1))
    if log_fn is not None:
        log_fn(f"render cache: packed density+k0, {table.numel() * table.element_size() / 1e9:.3f}"
               " GB")
    return table


def forward(
    params: DCVGOParams,
    cfg: DCVGOConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    near: float = 0.0,
    stepsize: float | None = None,
    bg: float = 1.0,
    bg_color: torch.Tensor | None = None,
    cache: torch.Tensor | None = None,
    compact: bool = False,
) -> common.RenderResult:
    """Volume rendering. ``near`` is ignored (the contracted sampling starts
    at the camera). ``bg_color`` [N, 3] is the random background of
    ``rand_bkgd`` training, else ``bg`` is composited. ``cache`` is the table
    of :func:`build_render_cache`. ``compact``: k0 and the colours only at
    the samples over both thresholds (:func:`..common.colour`), raw_rgb
    [K, 3] at ``rgb_rows``; else at every sample."""
    del near
    stepsize = cfg.stepsize if stepsize is None else stepsize
    N = rays_o.shape[0]
    interval = stepsize * cfg.voxel_size_ratio
    with common.sample_grad(rays_o, rays_d), span("forward/sample"):
        pts, inner, t = sample_ray(cfg, rays_o, rays_d)
        S = pts.shape[1]
        mask = oversample_mask(cfg, pts.detach(), inner, stepsize) & params.mask_cache(pts)
    with span("forward/density_k0"):
        density, k0_at = query_density(params, pts, cache)
    with span("forward/march"):
        alpha, weights, alphainv_last, mask = common.march(density, mask, params.act_shift,
                                                           interval, cfg.fast_color_thres)
    with span("forward/rgb"):
        rgb_marched, rgb, rows = common.colour(
            mask, weights, alphainv_last, bg if bg_color is None else bg_color, viewdirs, k0_at,
            lambda k0, vd: common.rgb_head(params.rgbnet, k0, vd, cfg.viewbase_pe), compact)
    t2 = t.expand(N, S)
    s = 1.0 - 1.0 / (1.0 + t2)
    return common.RenderResult(
        rgb_marched=rgb_marched,
        alphainv_last=alphainv_last,
        weights=weights,
        raw_alpha=alpha,
        raw_rgb=rgb,
        raw_density=density,
        mask=mask,
        t=t2,
        s=s,
        depth=torch.sum(weights * s, dim=-1),
        n_max=S,
        wsum_mid=torch.sum(weights * inner.to(weights.dtype), dim=-1),
        rgb_rows=rows,
    )


def lattice(xyz_min, xyz_max, ws, device) -> torch.Tensor:
    axes = [fg._linspace(mn, mx, int(n), device) for mn, mx, n in zip(xyz_min, xyz_max, ws)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


# above this many voxels the JAX package keeps the occupancy cache as it is
# at a boundary (a dense refresh of a 320^3 grid would not fit its budget)
REFRESH_MAX_VOXELS = 256**3


def resize_and_refresh(params, cfg, new_cfg, alpha_of, report: dict | None = None) -> None:
    """Both grids resampled to ``new_cfg``'s world size, in place (new
    parameters; an optimizer built on the old ones is void). Up to 256^3
    voxels the occupancy cache becomes a mask on the new lattice: the old
    mask there, and the 3^3 max-pool of ``alpha_of(density [X, Y, Z])`` above
    ``fast_color_thres``; above that it stays as it is. ``report``, if given,
    receives the seconds of "resize" and "refresh" and "carried", the share
    of the new lattice that the old mask holds (the mask's own share where it
    is kept). DMPIGO's boundary is this one with its own alpha.

    A density cut along x over a grid group (``--grid_parallel``) refreshes
    slab by slab: each rank takes the alpha of its slab, pools it with its
    neighbours' edge planes (``halo.max_pool_3x3_slab``), thresholds it, and
    the slabs of the bool mask are gathered on every rank; the mask stays
    whole, and equal to the whole grid's to the bit."""
    ws = new_cfg.world_size
    dev = params.mask_cache.mask.device
    t0 = time.perf_counter()
    params.density.scale_volume_grid(ws)
    params.k0.scale_volume_grid(ws)
    resize = seconds_since(t0, dev)
    t0 = time.perf_counter()
    if int(np.prod(ws)) <= REFRESH_MAX_VOXELS:
        with torch.no_grad():
            carried = params.mask_cache(lattice(cfg.xyz_min, cfg.xyz_max, ws, dev))
            shard = getattr(params.density, "shard", None)
            if shard is None:
                alive = interp.max_pool_3d_same(alpha_of(params.density.get_dense_grid()[..., 0]))
                alive = alive > new_cfg.fast_color_thres
            else:
                pooled = halo.max_pool_3x3_slab(alpha_of(params.density.grid[0, ..., 0]), shard)
                alive = halo.all_gather_x(pooled > new_cfg.fast_color_thres, shard, axis=0)
            new_mask = carried & alive
        params.mask_cache = MaskGrid(ws, cfg.xyz_min, cfg.xyz_max, mask=new_mask)
        share = float(carried.float().mean())
    else:
        share = float(params.mask_cache.mask.float().mean())
    if report is not None:
        report.update(resize=resize, refresh=seconds_since(t0, dev), carried=share)


def scale_volume_grid(params: DCVGOParams, cfg: DCVGOConfig, num_voxels: int,
                      report: dict | None = None):
    """The ``pg_scale`` boundary to ``num_voxels`` (:func:`resize_and_refresh`
    with the alpha of the new voxel size). Returns (params, new config)."""
    new_cfg = cfg.with_num_voxels(num_voxels)
    resize_and_refresh(params, cfg, new_cfg,
                       lambda d: activate_density(params, new_cfg, d.float()), report)
    return params, new_cfg


def refresh_occupancy(params, cfg, alpha_of):
    """The occupancy cache ANDed with the 3^3 max-pool of ``alpha_of`` of the
    density queried at the cache's own lattice; in place, returns
    ``params``."""
    mask = params.mask_cache.mask
    with torch.no_grad():
        xyz = lattice(cfg.xyz_min, cfg.xyz_max, mask.shape, mask.device)
        alpha = alpha_of(params.density(xyz)[..., 0])
        params.mask_cache.mask = mask & (interp.max_pool_3d_same(alpha) > cfg.fast_color_thres)
    return params


def update_occupancy_cache(params: DCVGOParams, cfg: DCVGOConfig) -> DCVGOParams:
    """:func:`refresh_occupancy` with the alpha of the config's voxel size."""
    return refresh_occupancy(params, cfg, lambda d: activate_density(params, cfg, d))
