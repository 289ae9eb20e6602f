"""DVGO: bounded scenes in one box of voxels (DirectVoxGO; the ``nerf/``,
``nsvf/``, ``deepvoxels/``, ``blendedmvs/``, ``tankstemple/<Scene>.py`` and
``tiny/`` configs), with its coarse stage.

Counterpart of ``unboundednerfpytorch_tpu/models/dvgo.py``: ``DVGOConfig``
and its derived sizes, ``config_from`` (the JAX ``build_model``'s dvgo
branch), ``create``, ``activate_density``, ``forward`` (equidistant marching
through the box, the occupancy cache, ``fast_color_thres`` before and after
the scan, colour from k0 alone or from the rgb MLP in its three modes),
``build_render_cache``, ``hit_coarse_geo`` (the ``in_maskcache`` ray
filter), ``maskout_near_cam_vox``, ``scale_volume_grid``,
``update_occupancy_cache`` and ``voxel_count_views`` (``pervoxel_lr``).

Density and k0 are one-bank :class:`..fields.grids.DenseGrid` s, ``[1, X, Y,
Z, C]`` in the port's layout, as DCVGO's, or, where the config names them
(``nerf/ship.tensorf.py``), :class:`..fields.grids.TensoRFGrid` s
(:func:`make_grid`); the scan is the fused CUDA march of
:func:`.common.march`, and a ``pg_scale`` boundary is DCVGO's
:func:`.dcvgo.resize_and_refresh`, through the grid's ``get_dense_grid``. As
in the JAX package a TensoRF model renders without a cache. A TensoRF
field's query runs under the ``field/vm`` span inside ``forward/density_k0``,
and its backward under ``backward/vm`` inside ``train_step/backward``
(:class:`..fields.grids.TensoRFGrid`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from unboundednerfpytorch_tpu_torch.configs.schema import normalize_fast_color_thres
from unboundednerfpytorch_tpu_torch.fields.grids import (
    DenseGrid, MaskGrid, TensoRFGrid, _norm01,
)
from unboundednerfpytorch_tpu_torch.fields.mlp import MLP
from unboundednerfpytorch_tpu_torch.models import common, dcvgo
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.ops import interp, sampling
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DVGOConfig:
    """The JAX ``DVGOConfig``'s fields; sizes follow from the box and the
    voxel counts."""

    xyz_min: tuple
    xyz_max: tuple
    num_voxels: int
    num_voxels_base: int
    alpha_init: float = 1e-6
    fast_color_thres: float = 0.0
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    rgbnet_dim: int = 0
    rgbnet_direct: bool = False
    rgbnet_full_implicit: bool = False
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4
    mask_cache_world_size: tuple | None = None
    mask_cache_thres: float = 1e-3
    grid_dtype: str = "float32"

    @property
    def voxel_size(self) -> float:
        ext = np.prod(np.array(self.xyz_max) - np.array(self.xyz_min))
        return float((ext / self.num_voxels) ** (1.0 / 3.0))

    @property
    def voxel_size_base(self) -> float:
        ext = np.prod(np.array(self.xyz_max) - np.array(self.xyz_min))
        return float((ext / self.num_voxels_base) ** (1.0 / 3.0))

    @property
    def world_size(self) -> tuple:
        ext = np.array(self.xyz_max) - np.array(self.xyz_min)
        return tuple(int(v) for v in (ext / self.voxel_size).astype(np.int64))

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def act_shift(self) -> float:
        return common.act_shift_from_alpha_init(self.alpha_init)

    @property
    def k0_dim(self) -> int:
        if self.rgbnet_dim <= 0:
            return 3
        return 0 if self.rgbnet_full_implicit else self.rgbnet_dim

    @property
    def rgbnet_in_dim(self) -> int:
        dim0 = 3 + 3 * self.viewbase_pe * 2
        if self.rgbnet_full_implicit:
            return dim0
        if self.rgbnet_direct:
            return dim0 + self.k0_dim
        return dim0 + self.k0_dim - 3

    def with_num_voxels(self, num_voxels: int) -> "DVGOConfig":
        return dataclasses.replace(self, num_voxels=num_voxels)


def config_from(cfg_model, xyz_min, xyz_max, num_voxels) -> DVGOConfig:
    """From a ModelRenderConfig and the world box, as the JAX ``build_model``
    makes it: neither ``grid_dtype`` nor a view-embedding width is passed, so
    the grids are f32 and ``viewbase_pe`` is 4."""
    return DVGOConfig(
        xyz_min=tuple(float(v) for v in xyz_min),
        xyz_max=tuple(float(v) for v in xyz_max),
        num_voxels=num_voxels,
        num_voxels_base=cfg_model.num_voxels_base_rgb,
        alpha_init=cfg_model.alpha_init,
        fast_color_thres=normalize_fast_color_thres(cfg_model)[0],
        density_type=cfg_model.density_type,
        k0_type=cfg_model.k0_type,
        density_config=cfg_model.density_config,
        k0_config=cfg_model.k0_config,
        rgbnet_dim=cfg_model.rgbnet_dim,
        rgbnet_direct=cfg_model.rgbnet_direct,
        rgbnet_full_implicit=cfg_model.rgbnet_full_implicit,
        rgbnet_depth=cfg_model.rgbnet_depth,
        rgbnet_width=cfg_model.rgbnet_width,
        mask_cache_thres=cfg_model.mask_cache_thres,
    )


class DVGOParams(nn.Module):
    """density [1, X, Y, Z, 1], k0 [1, X, Y, Z, max(k0_dim, 1)], the rgb MLP
    (None without ``rgbnet_dim``), ``act_shift`` (a host float) and the
    occupancy cache."""

    def __init__(self, density: DenseGrid, k0: DenseGrid, rgbnet: MLP | None,
                 act_shift: float, mask_cache: MaskGrid):
        super().__init__()
        self.density = density
        self.k0 = k0
        self.rgbnet = rgbnet
        self.act_shift = float(act_shift)
        self.mask_cache = mask_cache


def make_grid(grid_type: str, channels: int, world_size, cfg: DVGOConfig, grid_cfg,
              generator: torch.Generator | None = None, device=None):
    """A field of ``channels`` (the JAX ``_make_grid``): a zero
    ``DenseGrid`` in the config's dtype, or a ``TensoRFGrid`` of
    ``grid_cfg``'s ``n_comp`` (and ``n_comp_xy``) drawn from
    ``generator``."""
    if grid_type == "DenseGrid":
        return DenseGrid(channels, world_size, cfg.xyz_min, cfg.xyz_max,
                         dtype=fg._DTYPES[cfg.grid_dtype], device=device)
    if grid_type == "TensoRFGrid":
        gc = dict(grid_cfg)
        return TensoRFGrid(channels, world_size, cfg.xyz_min, cfg.xyz_max, n_comp=gc["n_comp"],
                           n_comp_xy=gc.get("n_comp_xy"), generator=generator, device=device)
    raise NotImplementedError(grid_type)


def create(cfg: DVGOConfig, generator: torch.Generator | None = None,
           device=None) -> DVGOParams:
    """The two fields (:func:`make_grid`: zero dense grids, or TensoRF grids
    drawn from ``generator``), an all-true occupancy cache and a
    U(+-1/sqrt(fan_in)) MLP drawn from ``generator`` (a CPU generator;
    values are then moved)."""
    ws = cfg.world_size
    density = make_grid(cfg.density_type, 1, ws, cfg, cfg.density_config, generator, device)
    k0 = make_grid(cfg.k0_type, max(cfg.k0_dim, 1), ws, cfg, cfg.k0_config, generator, device)
    rgbnet = None
    if cfg.rgbnet_dim > 0:
        rgbnet = MLP(cfg.rgbnet_in_dim, cfg.rgbnet_width, 3, cfg.rgbnet_depth,
                     generator=generator, device=device)
    mask_cache = MaskGrid(cfg.mask_cache_world_size or ws, cfg.xyz_min, cfg.xyz_max,
                          device=device)
    return DVGOParams(density, k0, rgbnet, cfg.act_shift, mask_cache)


def n_samples(cfg: DVGOConfig, stepsize: float) -> int:
    return sampling.n_samples_cap(cfg.world_size, stepsize)


def activate_density(params: DVGOParams, cfg: DVGOConfig, density: torch.Tensor,
                     interval: float | None = None) -> torch.Tensor:
    interval = cfg.voxel_size_ratio if interval is None else interval
    return alpha_ops.raw2alpha(density, params.act_shift, interval)


def build_render_cache(params: DVGOParams, cfg: DVGOConfig, log_fn=None):
    """DCVGO's packed table of density and k0 together, or None where k0 is
    unused (``rgbnet_full_implicit``), a field is not a ``DenseGrid``, the
    grids differ in size or the table is over the memory guard."""
    if cfg.rgbnet_full_implicit or not (params.density.dense and params.k0.dense):
        return None
    return dcvgo.build_render_cache(params, cfg, log_fn=log_fn)


def _sample(cfg: DVGOConfig, rays_o, rays_d, near: float, stepsize: float, n: int):
    return sampling.sample_pts_on_rays(rays_o, rays_d, cfg.xyz_min, cfg.xyz_max, near,
                                       stepsize * cfg.voxel_size, n)


def rgb_of(params: DVGOParams, cfg: DVGOConfig, k0: torch.Tensor,
           viewdirs: torch.Tensor) -> torch.Tensor:
    """Sample colours [N, S, 3]: the sigmoid of k0's first three channels
    without an MLP; else the MLP on k0 (or its channels past the first
    three, which are then added to the MLP's output as the diffuse part) and
    the view-direction embedding; with ``rgbnet_full_implicit`` on the
    embedding alone."""
    if params.rgbnet is None:
        return torch.sigmoid(k0[..., :3])
    direct = cfg.rgbnet_direct or cfg.rgbnet_full_implicit
    k0_view = k0 if direct else k0[..., 3:]
    N, S = k0.shape[:2]
    vemb = common.viewdir_embedding(viewdirs, cfg.viewbase_pe)
    feat = torch.cat([k0_view, vemb[:, None, :].expand(N, S, vemb.shape[-1])], dim=-1)
    logit = params.rgbnet(feat)
    return torch.sigmoid(logit if direct else logit + k0[..., :3])


def forward(
    params: DVGOParams,
    cfg: DVGOConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: torch.Tensor,
    *,
    near: float,
    stepsize: float,
    bg: float = 1.0,
    cache: torch.Tensor | None = None,
    compact: bool = False,
) -> common.RenderResult:
    """Volume rendering on the scalar background ``bg`` (the JAX DVGO forward
    takes no random background). ``cache`` is the table of
    :func:`build_render_cache`. ``compact``: k0 and the colours only at the
    samples over both thresholds (:func:`..common.colour`), raw_rgb [K, 3]
    at ``rgb_rows``; else at every sample."""
    S = n_samples(cfg, stepsize)
    interval = stepsize * cfg.voxel_size_ratio
    with common.sample_grad(rays_o, rays_d), span("forward/sample"):
        pts, mask, t = _sample(cfg, rays_o, rays_d, near, stepsize, S)
        mask = mask & params.mask_cache(pts)
    with span("forward/density_k0"):
        if cfg.rgbnet_full_implicit:  # no k0 and no render cache
            density = params.density(pts)[..., 0]
            k0_at = lambda rows: common.rows_of(pts, rows)[..., :0]
        else:
            density, k0_at = dcvgo.query_density(params, pts, cache)
    with span("forward/march"):
        alpha, weights, alphainv_last, mask = common.march(density, mask, params.act_shift,
                                                           interval, cfg.fast_color_thres)
    with span("forward/rgb"):
        rgb_marched, rgb, rows = common.colour(
            mask, weights, alphainv_last, bg, viewdirs, k0_at,
            lambda k0, vd: rgb_of(params, cfg, k0, vd), compact)
    step_ids = torch.arange(S, dtype=weights.dtype, device=weights.device)[None, :]
    return common.RenderResult(
        rgb_marched=rgb_marched,
        alphainv_last=alphainv_last,
        weights=weights,
        raw_alpha=alpha,
        raw_rgb=rgb,
        raw_density=density,
        mask=mask,
        t=t,
        s=t,
        depth=torch.sum(weights * step_ids, dim=-1),
        n_max=S,
        rgb_rows=rows,
    )


@torch.no_grad()
def hit_coarse_geo(params: DVGOParams, cfg: DVGOConfig, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, near: float, stepsize: float) -> torch.Tensor:
    """Whether each ray's live samples meet the occupancy cache: bool [N]
    (the ``in_maskcache`` ray filter)."""
    pts, mask, _ = _sample(cfg, rays_o, rays_d, near, stepsize, n_samples(cfg, stepsize))
    return (mask & params.mask_cache(pts)).any(dim=-1)


@torch.no_grad()
def maskout_near_cam_vox(params: DVGOParams, cfg: DVGOConfig, cam_o,
                         near_clip: float) -> DVGOParams:
    """The density of every lattice node within ``near_clip`` of a camera
    centre (``cam_o`` [C, 3]) set to -100, in place; returns ``params``. The
    distance to the nearest camera is kept a camera at a time, not for all
    at once ([X, Y, Z, C] would be GBs at 100^3 and a hundred views). A
    TensoRF density has no dense grid to set: it raises, as the JAX
    version does. A density cut along x sets its own slab's nodes."""
    if not params.density.dense:
        raise TypeError(f"maskout_near_cam_vox needs a DenseGrid density, not "
                        f"{type(params.density).__name__}")
    grid = params.density.grid
    xyz = dcvgo.lattice(cfg.xyz_min, cfg.xyz_max, cfg.world_size, grid.device)
    d2 = None
    for c in torch.as_tensor(np.asarray(cam_o), dtype=torch.float32, device=grid.device):
        diff = xyz - c
        s = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
        d2 = s if d2 is None else torch.minimum(d2, s)
    near = torch.sqrt(d2) <= near_clip
    grid.data[0][mesh_mod.x_slab(near, params.density.shard, axis=0)] = -100.0
    return params


def scale_volume_grid(params: DVGOParams, cfg: DVGOConfig, num_voxels: int,
                      report: dict | None = None):
    """The ``pg_scale`` boundary to ``num_voxels``: both grids resampled and,
    up to 256^3 voxels, the occupancy cache refreshed on the new lattice
    (:func:`.dcvgo.resize_and_refresh` with the alpha of the new voxel size).
    Returns (params, new config)."""
    new_cfg = cfg.with_num_voxels(num_voxels)
    dcvgo.resize_and_refresh(params, cfg, new_cfg,
                             lambda d: activate_density(params, new_cfg, d.float()), report)
    return params, new_cfg


def update_occupancy_cache(params: DVGOParams, cfg: DVGOConfig) -> DVGOParams:
    """The occupancy cache ANDed with the 3^3 max-pool of the alpha of the
    density at the cache's own lattice above ``fast_color_thres``; in place."""
    return dcvgo.refresh_occupancy(params, cfg, lambda d: activate_density(params, cfg, d))


# nodes a slab of :func:`density_on_lattice` (a query holds eight corner
# indices and weights a node)
LATTICE_SLAB_NODES = 1 << 21


@torch.no_grad()
def density_on_lattice(density, axes):
    """The density field [X, Y, Z] (f32) queried through its grid at the
    lattice of the three 1-D node coordinates ``axes``, in x-slabs of at most
    ``LATTICE_SLAB_NODES`` nodes."""
    xs, ys, zs = axes
    out = torch.empty((len(xs), len(ys), len(zs)), dtype=torch.float32, device=xs.device)
    slab = max(1, LATTICE_SLAB_NODES // max(len(ys) * len(zs), 1))
    for a in range(0, len(xs), slab):
        xyz = torch.stack(torch.meshgrid(xs[a:a + slab], ys, zs, indexing="ij"), -1)
        out[a:a + slab] = density(xyz)[..., 0]
    return out


def coarse_mask_fn(density, act_shift, cfg, thres: float):
    """The fine stage's occupancy seed from the coarse model's density grid
    (and its ``act_shift`` and config): ``fn(world_size, xyz_min, xyz_max)``
    gives the 3^3 max-pool of the coarse alpha at the fine lattice's nodes
    ``>= thres`` (``mask_cache_thres``), bool [X, Y, Z]. The alpha is this
    module's :func:`activate_density` whatever the coarse family, as in the
    JAX ``run_train``: a DMPIGO ``act_shift`` [mpi_depth] is added along the
    lattice's last axis, plane k of the fine lattice taking the coarse plane
    k's bias."""

    def fn(world_size, xyz_min, xyz_max):
        dev = next(density.parameters()).device
        axes = [fg._linspace(mn, mx, int(n), dev)
                for mn, mx, n in zip(xyz_min, xyz_max, world_size)]
        alpha = alpha_ops.raw2alpha(density_on_lattice(density, axes), act_shift,
                                    cfg.voxel_size_ratio)
        return interp.max_pool_3d_same(alpha) >= thres

    return fn


def _chunk_rays(n_samples_per_ray: int) -> int:
    """Rays a chunk of :func:`voxel_count_views`: its corner indices (int64)
    and weights, with their stacking copies and the points, come to about
    320 bytes a sample, held under ``interp.SLICE_BYTES``."""
    return max(1, interp.SLICE_BYTES // (320 * n_samples_per_ray))


@torch.no_grad()
def voxel_count_views(params: DVGOParams, cfg: DVGOConfig, rays_o, rays_d, near: float,
                      stepsize: float) -> torch.Tensor:
    """For each voxel, the number of views (rays [V, R, 3], numpy or
    tensors, on any device; counted on the grid's) whose samples put a trilinear weight sum above 1
    on it: the [X, Y, Z, 1] f32 count that ``pervoxel_lr`` normalises.

    Every ray takes all S = ``n_samples_cap`` steps from its entry point, in
    or out of the box, as the JAX version does; a view's weights go into one
    f32 [X * Y * Z] sum by ``index_add_`` of the eight corners of each
    sample that has a corner on the lattice (the others would add only
    zeros), in chunks of rays that keep the chunk's corner indices and
    weights under 1 GiB (one 800x800 view of 357 samples a ray holds 1.8 G
    corner weights). The sums are taken in another order than the JAX
    gradient's, so a voxel whose sum lies within rounding of 1 may count
    otherwise."""
    dev = params.mask_cache.mask.device
    ws = tuple(int(v) for v in cfg.world_size)
    S = n_samples(cfg, stepsize)
    step = torch.arange(S, dtype=torch.float32, device=dev) * (stepsize * cfg.voxel_size)
    count = torch.zeros(ws, dtype=torch.float32, device=dev)
    acc = torch.empty(int(np.prod(ws)), dtype=torch.float32, device=dev)
    chunk = _chunk_rays(S)
    size = torch.tensor(ws, dtype=torch.float32, device=dev)
    scale = size - 1
    as_dev = lambda a: torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                                       else a, dtype=torch.float32, device=dev)
    for v in range(len(rays_o)):
        acc.zero_()
        n_rays = len(rays_o[v])
        for a in range(0, n_rays, chunk):
            ro, rd = as_dev(rays_o[v][a:a + chunk]), as_dev(rays_d[v][a:a + chunk])
            t_min, _ = sampling.ray_aabb(ro, rd, cfg.xyz_min, cfg.xyz_max, near)
            interpx = t_min[:, None] + step[None, :] / sampling._norm(rd)[:, None]
            pts = ro[:, None, :] + rd[:, None, :] * interpx[..., None]
            c01 = _norm01(pts, cfg.xyz_min, cfg.xyz_max)
            del pts, interpx
            # a sample has a corner on the lattice where floor(c) lies in
            # [-1, n - 1] on every axis (c as trilerp_corners computes it)
            c = c01 * scale
            c01 = c01[((c >= -1) & (c < size)).all(dim=-1)]
            del c
            idx, w = interp.trilerp_corners(c01, ws)
            del c01
            acc.index_add_(0, idx.reshape(-1), w.reshape(-1))
            del idx, w
        count += (acc > 1).view(ws).to(torch.float32)
    return count[..., None]
